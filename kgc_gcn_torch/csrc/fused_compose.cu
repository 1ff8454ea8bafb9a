// Kernel K3 of the port: the stacked schedule's fused compose + segment-sum
// (spmm_mode=stacked).
//
//   out[r, :] = sum over indptr[r] <= e < indptr[r+1] of
//               ((x[src[e], :] * norm[e]) * rel_all[rel[e], :]) * etab[e, :]
//
// x (n_ent, d), rel_all (n_rel_rows, d), etab (E, d) and norm (E,) are
// float32; src, rel (E,) and indptr (n_rows+1,) int32 over edges sorted by
// destination row; out (n_rows, d) float32, zeros for rows with no edges.
// Replaces the TPU kernel kgc_gcn_tpu/ops/spmm_pallas.py:_fused_kernel
// (called through _fused_compose_segment_sum), which reads a pre-gathered
// (E, 128) stream xgn = x[src] * norm, builds the relation rows by a hi/lo
// bfloat16 one-hot matmul and sums through a dst one-hot matmul.  None of
// that carries over: on the card the rows are gathered and summed directly.
//
// Bound: memory.  The least traffic is x, rel_all, etab, src, rel, norm and
// indptr read once and out written once,
//   4*(n_ent*d + n_rel_rows*d + E*d + 3*E + n_rows + 1 + n_rows*d) bytes,
// against three multiplies and one add per edge element.  The design:
//   * the row gather of x happens inside the kernel: x (16.4 MB at WN18RR)
//     stays in the 50 MB L2, so the (E, d) xgn stream that the TPU kernel
//     reads (69.6 MB there) is never written or read;
//   * one warp owns one destination row and walks its CSR edge range; lane l
//     accumulates columns l, l+32, ... in float32 registers, so each edge's
//     rows are coalesced reads and each output row one write; edges are
//     sorted by destination, so no two warps write the same row: no atomics,
//     no memset (empty rows write their zeros), a fixed summation order;
//   * a row's edge metadata (src, rel, norm) is read once per edge: the 32
//     lanes load 32 edges' worth, and __shfl_sync broadcasts each in turn;
//   * the warps take the rows from the top of each half downwards,
//     alternating between the halves (2N-1, N-1, 2N-2, N-2, ...), so the
//     grid's first block holds the last row of each half.  The graph puts
//     each half's zero-norm padding edges in that row (205 at WN18RR): their
//     serial walk then overlaps the rest of the grid instead of trailing it;
//   * rel_all is read through the read-only data cache, not staged in shared
//     memory: at WN18RR a row holds ~2 edges (174,080 over 81,886 rows), so
//     staging its 9.2 KB in every block of 8 rows would move more bytes than
//     the block's edges do;
//   * the products are rounded one by one in the plain version's order
//     (__fmul_rn is never contracted into the add), so on inputs whose
//     products and partial sums are exact the result equals the plain
//     version's to the bit.
// Known limit: a hub row still runs in one warp, at about one memory latency
// per edge.  Loading 4 edges' rows ahead of their products did not pay on
// the H100: it took 80 registers a thread against 44, and the lost
// occupancy slowed the short rows more than the overlap sped up the hubs.
//
// The kernel does not read the destination ids; it asserts on the device that
// each row's range lies inside [0, E] and each edge's src and rel inside
// their tables, so a bad index faults instead of reading out of bounds.

#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxColsPerLane = 8;
constexpr int kColChunk = 32 * kMaxColsPerLane;   // columns per blockIdx.y
constexpr unsigned kFull = 0xffffffffu;

// One message element, each product rounded in the plain version's order.
__device__ __forceinline__ float compose(float x, float norm, float rel,
                                         float e) {
  return __fmul_rn(__fmul_rn(__fmul_rn(x, norm), rel), e);
}

template <int kColsPerLane>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_compose_kernel(const float* __restrict__ x, const int* __restrict__ src,
                     const float* __restrict__ norm,
                     const float* __restrict__ rel_all,
                     const int* __restrict__ rel,
                     const float* __restrict__ etab,
                     const int* __restrict__ indptr, float* __restrict__ out,
                     int n_rows, int n_edges, int d, int n_ent,
                     int n_rel_rows) {
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n_rows) return;   // uniform across the warp
  // even i walk [lower, n_rows) down from its top, odd i [0, lower)
  const int lower = n_rows >> 1;
  const int row = (i & 1) ? lower - 1 - (i >> 1) : n_rows - 1 - (i >> 1);
  const int lane = threadIdx.x & 31;
  const int col0 = blockIdx.y * kColChunk + lane;
  const int e0 = indptr[row];
  const int e1 = indptr[row + 1];
  assert(0 <= e0 && e0 <= e1 && e1 <= n_edges);

  float acc[kColsPerLane];
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) acc[c] = 0.f;

  for (int base = e0; base < e1; base += 32) {
    // lane k loads edge base + k's metadata once
    int s = 0, r = 0;
    float nm = 0.f;
    if (base + lane < e1) {
      s = src[base + lane];
      r = rel[base + lane];
      nm = norm[base + lane];
      assert(0 <= s && s < n_ent && 0 <= r && r < n_rel_rows);
    }
    const int count = e1 - base < 32 ? e1 - base : 32;   // uniform
    for (int k = 0; k < count; ++k) {
      const float* xr = x + static_cast<int64_t>(__shfl_sync(kFull, s, k)) * d;
      const float* rr =
          rel_all + static_cast<int64_t>(__shfl_sync(kFull, r, k)) * d;
      const float* er = etab + static_cast<int64_t>(base + k) * d;
      const float n = __shfl_sync(kFull, nm, k);
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int col = col0 + 32 * c;
        if (col < d) {
          acc[c] = __fadd_rn(acc[c],
                             compose(xr[col], n, __ldg(rr + col), er[col]));
        }
      }
    }
  }

  float* o = out + static_cast<int64_t>(row) * d;
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) {
    const int col = col0 + 32 * c;
    if (col < d) o[col] = acc[c];
  }
}

struct Args {
  const float* x;
  const int* src;
  const float* norm;
  const float* rel_all;
  const int* rel;
  const float* etab;
  const int* indptr;
  float* out;
  int n_rows, n_edges, d, n_ent, n_rel_rows;
};

template <int kColsPerLane>
void launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (a.d + kColChunk - 1) / kColChunk);
  fused_compose_kernel<kColsPerLane><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      a.x, a.src, a.norm, a.rel_all, a.rel, a.etab, a.indptr, a.out, a.n_rows,
      a.n_edges, a.d, a.n_ent, a.n_rel_rows);
}

}  // namespace

// Launches K3 on `stream`; returns the cudaError_t of the launch (0: success).
// The caller guarantees n_rows > 0 and d > 0 and owns every buffer.
extern "C" int kgc_fused_compose(const void* x, const void* src,
                                 const void* norm, const void* rel_all,
                                 const void* rel, const void* etab,
                                 const void* indptr, void* out, int n_rows,
                                 int n_edges, int d, int n_ent, int n_rel_rows,
                                 void* stream) {
  const Args a{static_cast<const float*>(x),      static_cast<const int*>(src),
               static_cast<const float*>(norm),   static_cast<const float*>(rel_all),
               static_cast<const int*>(rel),      static_cast<const float*>(etab),
               static_cast<const int*>(indptr),   static_cast<float*>(out),
               n_rows, n_edges, d, n_ent, n_rel_rows};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = d < kColChunk ? d : kColChunk;
  const int cols_per_lane = (width + 31) / 32;
  if (cols_per_lane <= 1) {
    launch<1>(a, s);
  } else if (cols_per_lane <= 2) {
    launch<2>(a, s);
  } else if (cols_per_lane <= 4) {
    launch<4>(a, s);
  } else {
    launch<8>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}
