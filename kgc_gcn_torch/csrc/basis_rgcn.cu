// Kernels K7 and K8 of the port: basis-decomposed R-GCN aggregation and its
// backward, over edges sorted by destination row with CSR pointers indptr.
//
// K7 (forward), msg (E, d) f32, a (E, B) f32 -> out (n_rows, B*d) f32:
//   out[n, b*d + j] = sum over indptr[n] <= e < indptr[n+1] of a[e, b] * msg[e, j]
// with zeros for rows that have no edges.  Replaces the TPU kernel
// kgc_gcn_tpu/ops/spmm_pallas.py:_basis_kernel (called through
// _basis_fused_call).
//
// K8 (backward), g (n_rows, B*d) f32 -> d_msg (E, d) f32, d_a (E, B) f32; for
// each edge e of row n, with sel = g[n] viewed as (B, d):
//   d_msg[e, j] = sum_b a[e, b] * sel[b, j]
//   d_a[e, b]   = sum_j sel[b, j] * msg[e, j]
// Replaces kgc_gcn_tpu/ops/spmm_pallas.py:_basis_bwd_kernel (called through
// _basis_bwd_call).
//
// What is left of the TPU kernels is what they compute.  The 128-lane
// padding, the hi/lo bf16 split for near-float32 MXU products, the one-hot
// row selection and the per-tile padded edge plan (build_basis_bwd_plan) are
// not carried over: a block that walks one destination row's CSR range owns
// exactly that row's edges, so K8 reads the dst-sorted edges directly and
// every output element is written by one block, with no atomics and no
// memset.  Sums run in float32 in a fixed order, so results are
// deterministic.
//
// Bound: memory.  K7 must read msg and a once and write out once,
//   4*(E*d + E*B + n_rows+1 + n_rows*B*d) bytes
// against 2*E*B*d operations; K8 reads g, msg, a and writes d_msg, d_a,
//   4*(n_rows*B*d + 2*E*d + 2*E*B + n_rows+1) bytes
// against 4*E*B*d operations.  Both sit below the card's float32 balance of
// operations per byte (67e12 / 3.35e12 = 20), so bytes bound them.  The
// design reads each input byte from device memory once:
//   * one block per destination row stages the row's msg and a rows (one
//     contiguous range each, since edges are dst-sorted) in shared memory,
//     in chunks of up to 32 edges;
//   * K7: each thread owns kSlots (column j, group of 8 bases) slots and
//     keeps their 8*kSlots sums in registers; per edge it reads msg[e, j]
//     once and the 8 coefficients as two float4 broadcasts;
//   * K8: the row's cotangent g[n] (B*d floats) is staged once.  Per edge
//     chunk, d_a and d_msg are two small products with G, computed from
//     register tiles (2 edges x 4 bases, 4 edges x 4 columns) fed by float4
//     shared-memory reads laid out to avoid bank conflicts, so each read
//     serves 4-8 multiply-adds; warps split between the two products;
//   * block x takes row n_rows-1-x, so the zero-norm padding edges, which all
//     sit in the last row, start in the first wave instead of the last.
// K8's shared memory grows with B*d (bwd_smem_bytes); the launcher refuses a
// shape whose row does not fit in one block's opt-in maximum (kMaxSmem), and
// the Python wrapper checks the same bound before it launches.

#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;        // K7 block
constexpr int kBwdThreads = 256;     // K8 block
constexpr int kGroup = 8;            // K7: bases one slot accumulates
constexpr int kMaxChunk = 32;        // edges staged per pass
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;     // one block's opt-in maximum (227 KB)

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

template <int kSlots>
__global__ void __launch_bounds__(kThreads)
basis_sum_kernel(const float* __restrict__ msg, const float* __restrict__ a,
                 const int* __restrict__ indptr, float* __restrict__ out,
                 int n_rows, int n_edges, int d, int nb, int chunk) {
  extern __shared__ float4 smem4[];
  const int nb_pad = round_up(nb, kGroup);
  float* a_s = reinterpret_cast<float*>(smem4);   // (chunk, nb_pad), 0 past nb
  float* m_s = a_s + chunk * nb_pad;               // (chunk, d)
  const int row = n_rows - 1 - static_cast<int>(blockIdx.x);
  const int e0 = indptr[row];
  const int e1 = indptr[row + 1];
  assert(0 <= e0 && e0 <= e1 && e1 <= n_edges);

  const int n_slots = d * (nb_pad / kGroup);
  int col[kSlots], grp[kSlots];
  bool live[kSlots];
  float acc[kSlots][kGroup];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int slot = (blockIdx.y * kSlots + k) * kThreads + threadIdx.x;
    live[k] = slot < n_slots;
    const int s = live[k] ? slot : 0;
    grp[k] = s / d;
    col[k] = s - grp[k] * d;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) acc[k][i] = 0.f;
  }

  for (int c0 = e0; c0 < e1; c0 += chunk) {
    const int n = min(chunk, e1 - c0);
    __syncthreads();                     // the previous chunk is consumed
    const float* ms = msg + static_cast<int64_t>(c0) * d;
    for (int i = threadIdx.x; i < n * d; i += kThreads) m_s[i] = ms[i];
    const float* as = a + static_cast<int64_t>(c0) * nb;
    for (int i = threadIdx.x; i < n * nb_pad; i += kThreads) {
      const int t = i / nb_pad;
      const int b = i - t * nb_pad;
      a_s[i] = b < nb ? as[t * nb + b] : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float* at = a_s + t * nb_pad;
      const float* mt = m_s + t * d;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const float m = mt[col[k]];
        const float4 lo = *reinterpret_cast<const float4*>(at + grp[k] * kGroup);
        const float4 hi = *reinterpret_cast<const float4*>(at + grp[k] * kGroup + 4);
        acc[k][0] = fmaf(lo.x, m, acc[k][0]);
        acc[k][1] = fmaf(lo.y, m, acc[k][1]);
        acc[k][2] = fmaf(lo.z, m, acc[k][2]);
        acc[k][3] = fmaf(lo.w, m, acc[k][3]);
        acc[k][4] = fmaf(hi.x, m, acc[k][4]);
        acc[k][5] = fmaf(hi.y, m, acc[k][5]);
        acc[k][6] = fmaf(hi.z, m, acc[k][6]);
        acc[k][7] = fmaf(hi.w, m, acc[k][7]);
      }
    }
  }

  float* o = out + static_cast<int64_t>(row) * nb * d;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (!live[k]) continue;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int b = grp[k] * kGroup + i;
      if (b < nb) o[b * d + col[k]] = acc[k][i];
    }
  }
}

// K8 shared-memory layout (floats): the row's cotangent G (nb_pad x S), the
// chunk's messages M (kBwdChunk x S) and its coefficients transposed, A_T
// (nb_pad x kAtStride).  S = d rounded up to a multiple of 4 whose quotient
// by 4 is odd, so that float4 reads of 8 different rows hit 8 different
// bank groups; columns d..S-1 and rows nb..nb_pad-1 of G are zeros.
constexpr int kBwdChunk = 32;               // edges staged per pass
constexpr int kAtStride = kBwdChunk + 4;    // A_T row stride (float4-aligned)
constexpr int kBasisTile = 32;              // bases per d_a task

__host__ __device__ inline int bwd_stride(int d) {
  const int s = round_up(d, 4);
  return (s / 4) % 2 ? s : s + 4;
}

__host__ __device__ inline int64_t bwd_smem_bytes(int d, int nb) {
  const int64_t nb_pad = round_up(nb, kBasisTile);
  const int64_t s = bwd_stride(d);
  return 4 * (nb_pad * s + kBwdChunk * s + nb_pad * kAtStride);
}

__device__ __forceinline__ void fma4(float& acc, const float4& x,
                                     const float4& y) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  acc = fmaf(x.w, y.w, acc);
}

__global__ void __launch_bounds__(kBwdThreads)
basis_bwd_kernel(const float* __restrict__ g, const float* __restrict__ msg,
                 const float* __restrict__ a, const int* __restrict__ indptr,
                 float* __restrict__ d_msg, float* __restrict__ d_a,
                 int n_rows, int n_edges, int d, int nb) {
  extern __shared__ float4 smem4[];
  const int S = bwd_stride(d);
  const int S4 = S / 4;
  const int nb_pad = round_up(nb, kBasisTile);
  float* g_s = reinterpret_cast<float*>(smem4);   // (nb_pad, S)
  float* m_s = g_s + nb_pad * S;                   // (kBwdChunk, S)
  float* at_s = m_s + kBwdChunk * S;               // (nb_pad, kAtStride)
  const float4* g4 = reinterpret_cast<const float4*>(g_s);
  const float4* m4 = reinterpret_cast<const float4*>(m_s);
  const float4* at4 = reinterpret_cast<const float4*>(at_s);
  const int row = n_rows - 1 - static_cast<int>(blockIdx.x);
  const int e0 = indptr[row];
  const int e1 = indptr[row + 1];
  assert(0 <= e0 && e0 <= e1 && e1 <= n_edges);
  if (e0 == e1) return;                  // a row without edges owns no output

  const float* gr = g + static_cast<int64_t>(row) * nb * d;
  for (int i = threadIdx.x; i < nb_pad * S; i += kBwdThreads) {
    const int b = i / S;
    const int j = i - b * S;
    g_s[i] = (b < nb && j < d) ? gr[b * d + j] : 0.f;
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_groups = nb_pad / kBasisTile;
  const int d4 = (d + 3) / 4;

  for (int c0 = e0; c0 < e1; c0 += kBwdChunk) {
    const int n = min(kBwdChunk, e1 - c0);
    __syncthreads();                     // g_s staged / previous chunk consumed
    const float* ms = msg + static_cast<int64_t>(c0) * d;
    for (int i = threadIdx.x; i < n * S; i += kBwdThreads) {
      const int t = i / S;
      const int j = i - t * S;
      m_s[i] = j < d ? ms[t * d + j] : 0.f;
    }
    const float* as = a + static_cast<int64_t>(c0) * nb;
    for (int i = threadIdx.x; i < n * nb; i += kBwdThreads) {
      const int t = i / nb;
      const int b = i - t * nb;
      at_s[b * kAtStride + t] = as[i];
    }
    __syncthreads();

    // Warps [0, da_warps) take the d_a tasks; the others, or all warps
    // after the d_a tasks when those fill every warp, take the d_msg tiles.
    // Rows of M past n and of A_T past n hold stale values: they only reach
    // outputs that are not stored.
    const int da_tasks = ((n + 7) / 8) * n_groups;
    const bool split = da_tasks < kBwdThreads / 32;
    const int da_warps = split ? da_tasks : kBwdThreads / 32;

    // d_a[e, b] = sum_j G[b, j] * M[e, j].  A task is 8 edges x 32 bases:
    // lane (tt, bt) owns edges tt + 4k (k < 2) and bases bt + 8k (k < 4) and
    // walks j four columns at a time; its 8 float4 reads serve 32 products.
    if (warp < da_warps) {
      const int tt = lane >> 3;
      const int bt = lane & 7;
      for (int task = warp; task < da_tasks; task += da_warps) {
        const int t0 = (task / n_groups) * 8 + tt;
        const int b0 = (task % n_groups) * kBasisTile + bt;
        float acc[2][4] = {};
        for (int q = 0; q < S4; ++q) {
          const float4 m0 = m4[t0 * S4 + q];
          const float4 m1 = m4[(t0 + 4) * S4 + q];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float4 gv = g4[(b0 + 8 * k) * S4 + q];
            fma4(acc[0][k], m0, gv);
            fma4(acc[1][k], m1, gv);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int t = t0 + 4 * i;
          if (t >= n) continue;
          float* da = d_a + static_cast<int64_t>(c0 + t) * nb;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int b = b0 + 8 * k;
            if (b < nb) da[b] = acc[i][k];
          }
        }
      }
    }
    // d_msg[e, j] = sum_b A[e, b] * G[b, j].  A tile is 4 edges x 4
    // columns: per basis one float4 of G and one of A_T serve 16 products.
    if (!split || warp >= da_warps) {
      const int first = split ? threadIdx.x - da_warps * 32 : threadIdx.x;
      const int step = split ? kBwdThreads - da_warps * 32 : kBwdThreads;
      const int n_tiles = ((n + 3) / 4) * d4;
      for (int tile = first; tile < n_tiles; tile += step) {
        const int tq = tile / d4;
        const int q = tile - tq * d4;
        float4 acc[4] = {};
        for (int b = 0; b < nb; ++b) {
          const float4 gv = g4[b * S4 + q];
          const float4 av = at4[b * (kAtStride / 4) + tq];
          const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[k].x = fmaf(ak[k], gv.x, acc[k].x);
            acc[k].y = fmaf(ak[k], gv.y, acc[k].y);
            acc[k].z = fmaf(ak[k], gv.z, acc[k].z);
            acc[k].w = fmaf(ak[k], gv.w, acc[k].w);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int t = 4 * tq + k;
          if (t >= n) continue;
          float* dm = d_msg + static_cast<int64_t>(c0 + t) * d + 4 * q;
          const float out[4] = {acc[k].x, acc[k].y, acc[k].z, acc[k].w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (4 * q + c < d) dm[c] = out[c];
        }
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int kSlots>
cudaError_t launch_sum(const float* msg, const float* a, const int* indptr,
                       float* out, int n_rows, int n_edges, int d, int nb,
                       int n_slots, int chunk, int smem, cudaStream_t stream) {
  const cudaError_t err = allow_smem(basis_sum_kernel<kSlots>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_rows, (n_slots + kThreads * kSlots - 1) / (kThreads * kSlots));
  basis_sum_kernel<kSlots><<<grid, kThreads, smem, stream>>>(
      msg, a, indptr, out, n_rows, n_edges, d, nb, chunk);
  return cudaGetLastError();
}

}  // namespace

// Launches K7 on `stream`; returns the cudaError_t of the launch (0: success).
// The caller guarantees n_rows > 0, d > 0, nb > 0 and owns every buffer.
extern "C" int kgc_basis_sum(const void* msg, const void* a, const void* indptr,
                             void* out, int n_rows, int n_edges, int d, int nb,
                             void* stream) {
  const int nb_pad = round_up(nb, kGroup);
  const int row_bytes = 4 * (nb_pad + d);
  int chunk = kDefaultSmem / row_bytes;
  if (chunk < 1) chunk = kMaxSmem / row_bytes;
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (chunk > kMaxChunk) chunk = kMaxChunk;
  const int smem = chunk * row_bytes;
  const int n_slots = d * (nb_pad / kGroup);
  const int per = (n_slots + kThreads - 1) / kThreads;
  const auto* m = static_cast<const float*>(msg);
  const auto* c = static_cast<const float*>(a);
  const auto* p = static_cast<const int*>(indptr);
  auto* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (per <= 1) {
    err = launch_sum<1>(m, c, p, o, n_rows, n_edges, d, nb, n_slots, chunk, smem, s);
  } else if (per <= 2) {
    err = launch_sum<2>(m, c, p, o, n_rows, n_edges, d, nb, n_slots, chunk, smem, s);
  } else if (per <= 4) {
    err = launch_sum<4>(m, c, p, o, n_rows, n_edges, d, nb, n_slots, chunk, smem, s);
  } else {
    err = launch_sum<8>(m, c, p, o, n_rows, n_edges, d, nb, n_slots, chunk, smem, s);
  }
  return static_cast<int>(err);
}

// Launches K8 on `stream`; returns the cudaError_t of the launch (0: success,
// cudaErrorInvalidValue when the shared memory a row needs, bwd_smem_bytes,
// exceeds kMaxSmem).  The caller guarantees n_rows > 0, d > 0, nb > 0.
extern "C" int kgc_basis_bwd(const void* g, const void* msg, const void* a,
                             const void* indptr, void* d_msg, void* d_a,
                             int n_rows, int n_edges, int d, int nb,
                             void* stream) {
  const int64_t smem = bwd_smem_bytes(d, nb);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(basis_bwd_kernel, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  basis_bwd_kernel<<<n_rows, kBwdThreads, static_cast<int>(smem),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(msg),
      static_cast<const float*>(a), static_cast<const int*>(indptr),
      static_cast<float*>(d_msg), static_cast<float*>(d_a), n_rows, n_edges, d,
      nb);
  return static_cast<int>(cudaGetLastError());
}
