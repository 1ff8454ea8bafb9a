// Kernel K1 of the port: sorted CSR segment-sum.
//
//   out[r, :] = sum over indptr[r] <= e < indptr[r+1] of msg[e, :]
//
// msg is (E, D) float32 or bfloat16; dst (E,) int32 the non-decreasing row
// of each edge and indptr (n_rows+1,) int32 its CSR pointers; out
// (n_rows, D) float32; rows with no edges get zeros.  Replaces the TPU kernel
// kgc_gcn_tpu/ops/spmm_pallas.py:_seg_kernel (called through
// segment_sum_pallas), without its TPU-only parts: the lane padding, the
// one-hot matmul and the hi/lo bf16 split.
//
// Bound: memory.  The least traffic is each message read once, indptr read
// once and each output row written once,
//   E*D*bytes(msg) + 4*(n_rows+1) + 4*n_rows*D bytes,
// against one add per message element, far below the card's balance of
// operations per byte.
//
// Schedule: two passes over fixed chunks of kChunk edges.  In pass A no lane
// group walks more than kChunk edges, whatever the degrees (a padding hub, a
// relation-order row of thousands of edges, a power-law entity); pass B
// still walks a split row's partials in series, ceil(deg / kChunk) of them,
// which sets the time of a row of thousands of edges:
//   * pass A: chunk k covers edges [k*C, (k+1)*C).  One lane group walks it,
//     its lanes over columns (32 lanes for D > 16, else the next power of two
//     >= D, so a warp walks 32/lanes chunks at small widths).  It loads
//     kBatch edges' rows (dst) and messages at once, then sums them in edge
//     order in float32 registers, closing a row where dst changes: no load
//     waits on another.  A row that lies wholly inside the chunk is written
//     to out; only the chunk's first and last rows can be split across
//     chunks, and their partial sums go to carry[k][slot] (slot 0: the row
//     holding edge k*C; slot 1: the chunk's last row, when it starts after
//     k*C);
//   * pass B: one lane group per row, from indptr (rows that pass A wrote
//     too: their group reads indptr and returns).  An empty row writes
//     zeros; a split row sums its partials in chunk order (slot 0 of every
//     chunk after its first), kBatch chunks' loads at a time, and writes
//     once.
// The extra traffic is dst (4 bytes an edge) and the carry: at most 2*D
// floats written and read per chunk, 2/C of a float32 message's bytes.  No
// atomics and no memset, and each row's summation order is fixed (in edge
// order within a chunk, then the chunks in order), so the output is
// bit-identical from run to run.
//
// The kernels assert on the device that indptr's ends and each row's range
// lie inside [0, E] and that dst rises inside [0, n_rows), so a bad input
// faults instead of reading or writing out of bounds, without a host sync on
// every launch.

#include <cassert>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;   // edges per chunk
constexpr int kThreads = 256;
constexpr int kMaxColsPerLane = 8;
constexpr int kColChunk = 32 * kMaxColsPerLane;   // columns per blockIdx.y

// Edges (pass A) or chunks (pass B) whose loads a lane issues together:
// about 32 values in registers.
template <int kColsPerLane>
__host__ __device__ constexpr int batch() {
  return kColsPerLane >= 8 ? 4 : kColsPerLane >= 4 ? 8 : 16;
}

struct Args {
  const void* msg;
  const int* dst;
  const int* indptr;
  float* out;
  float* carry;
  int n_rows, n_edges, d;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  // exact: a bfloat16 is the top half of a float32
  return __uint_as_float(static_cast<unsigned>(__bfloat16_as_ushort(v)) << 16);
}

// Writes a lane's columns of one row sum to o (a row of out or of carry).
template <int kLanes, int kColsPerLane>
__device__ __forceinline__ void store_row(float* __restrict__ o,
                                          const float (&acc)[kColsPerLane],
                                          int col0, int d) {
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) {
    const int col = col0 + kLanes * c;
    if (col < d) o[col] = acc[c];
  }
}

// Pass A: lane group per chunk of kChunk edges.
template <typename T, int kLanes, int kColsPerLane>
__global__ void __launch_bounds__(kThreads)
chunk_sums(const T* __restrict__ msg, const int* __restrict__ dst,
           const int* __restrict__ indptr, float* __restrict__ out,
           float* __restrict__ carry, int n_rows, int n_edges, int d,
           int n_chunks) {
  constexpr int kGroups = kThreads / kLanes;
  constexpr int kBatch = batch<kColsPerLane>();
  const int k = blockIdx.x * kGroups + threadIdx.x / kLanes;
  if (k >= n_chunks) return;
  const int col0 = blockIdx.y * kColChunk + threadIdx.x % kLanes;
  const int first = indptr[0];
  const int last = indptr[n_rows];
  assert(0 <= first && first <= last && last <= n_edges);
  const int c0 = k * kChunk;   // k < n_chunks, so c0 < E < 2**31
  const int e0 = c0 > first ? c0 : first;
  const int end = last - c0 <= kChunk ? last : c0 + kChunk;
  if (e0 >= end) return;   // no row holds an edge outside [first, last)

  float* const carry_k = carry + 2 * static_cast<int64_t>(k) * d;
  int row = dst[e0];
  assert(0 <= row && row < n_rows);
  // whether the first row starts inside the chunk; slot 0 holds edge c0's row
  bool starts = e0 == first || dst[e0 - 1] != row;
  int slot = e0 == c0 ? 0 : 1;
  float acc[kColsPerLane];
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) acc[c] = 0.f;
  for (int base = e0; base < end; base += kBatch) {
    int ids[kBatch];
    float v[kBatch][kColsPerLane];
    // every load is unconditional (past the chunk's end or the row's width
    // it reads the last edge or column again, unused) so all are in flight
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = base + j < end ? base + j : end - 1;
      ids[j] = dst[e];
      const T* m = msg + static_cast<int64_t>(e) * d;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int col = col0 + kLanes * c;
        v[j][c] = widen(m[col < d ? col : d - 1]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (base + j >= end) break;
      if (ids[j] != row) {   // the row ended inside the chunk
        assert(row < ids[j] && ids[j] < n_rows);
        store_row<kLanes>(starts ? out + static_cast<int64_t>(row) * d
                                 : carry_k + slot * d,
                          acc, col0, d);
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) acc[c] = 0.f;
        row = ids[j];
        starts = true;
        slot = 1;
      }
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) acc[c] += v[j][c];
    }
  }
  // the chunk's last row is whole if it also ends inside the chunk
  const bool ends = end == last || dst[end] != row;
  store_row<kLanes>(starts && ends ? out + static_cast<int64_t>(row) * d
                                   : carry_k + slot * d,
                    acc, col0, d);
}

// Pass B: lane group per row; zeros for empty rows, the chunks' partials in
// chunk order for rows split across chunks.
template <int kLanes, int kColsPerLane>
__global__ void __launch_bounds__(kThreads)
row_fixup(const int* __restrict__ indptr, const float* __restrict__ carry,
          float* __restrict__ out, int n_rows, int n_edges, int d) {
  constexpr int kGroups = kThreads / kLanes;
  constexpr int kBatch = batch<kColsPerLane>();
  const int row = blockIdx.x * kGroups + threadIdx.x / kLanes;
  if (row >= n_rows) return;
  const int col0 = blockIdx.y * kColChunk + threadIdx.x % kLanes;
  const int e0 = indptr[row];
  const int e1 = indptr[row + 1];
  assert(0 <= e0 && e0 <= e1 && e1 <= n_edges);
  float acc[kColsPerLane];
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) acc[c] = 0.f;
  if (e0 != e1) {
    const int k0 = e0 / kChunk;
    const int k1 = (e1 - 1) / kChunk;
    if (k0 == k1) return;   // pass A wrote the row
    const float* p = carry + (2 * static_cast<int64_t>(k0)
                              + (e0 == k0 * kChunk ? 0 : 1)) * d;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int col = col0 + kLanes * c;
      if (col < d) acc[c] = p[col];
    }
    for (int base = k0 + 1; base <= k1; base += kBatch) {
      float v[kBatch][kColsPerLane];
      // predicated loads: issued together, ahead of the adds
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        p = carry + 2 * static_cast<int64_t>(base + j) * d;
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) {
          const int col = col0 + kLanes * c;
          v[j][c] = base + j <= k1 && col < d ? p[col] : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (base + j > k1) break;
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) acc[c] += v[j][c];
      }
    }
  }
  store_row<kLanes>(out + static_cast<int64_t>(row) * d, acc, col0, d);
}

template <typename T, int kLanes, int kColsPerLane>
cudaError_t launch_passes(const Args& a, cudaStream_t stream) {
  constexpr int kGroups = kThreads / kLanes;
  const int n_chunks =
      static_cast<int>((static_cast<int64_t>(a.n_edges) + kChunk - 1) / kChunk);
  const unsigned col_blocks = (a.d + kColChunk - 1) / kColChunk;
  if (n_chunks > 0) {   // E == 0: no chunk, pass B writes the zeros
    const dim3 grid((n_chunks + kGroups - 1) / kGroups, col_blocks);
    chunk_sums<T, kLanes, kColsPerLane><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(a.msg), a.dst, a.indptr, a.out, a.carry,
        a.n_rows, a.n_edges, a.d, n_chunks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.n_rows + kGroups - 1) / kGroups, col_blocks);
  row_fixup<kLanes, kColsPerLane><<<grid, kThreads, 0, stream>>>(
      a.indptr, a.carry, a.out, a.n_rows, a.n_edges, a.d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t s) {
  // lanes per group: the next power of two >= D up to 16, then a warp
  if (a.d <= 1) return launch_passes<T, 1, 1>(a, s);
  if (a.d <= 2) return launch_passes<T, 2, 1>(a, s);
  if (a.d <= 4) return launch_passes<T, 4, 1>(a, s);
  if (a.d <= 8) return launch_passes<T, 8, 1>(a, s);
  if (a.d <= 16) return launch_passes<T, 16, 1>(a, s);
  if (a.d <= 32) return launch_passes<T, 32, 1>(a, s);
  if (a.d <= 64) return launch_passes<T, 32, 2>(a, s);
  if (a.d <= 128) return launch_passes<T, 32, 4>(a, s);
  return launch_passes<T, 32, 8>(a, s);
}

}  // namespace

// Edges per chunk of pass A: the caller's carry buffer is
// (ceil(n_edges / chunk), 2, d) float32.
extern "C" int kgc_segment_sum_chunk() { return kChunk; }

// Launches K1's two passes on `stream`; returns the cudaError_t of the
// launches (0: success).  The caller guarantees n_rows > 0 and d > 0 and owns
// every buffer, carry included (uninitialised scratch, sized as above).
extern "C" int kgc_segment_sum(const void* msg, int msg_is_bf16,
                               const void* dst, const void* indptr, void* out,
                               void* carry, int n_rows, int n_edges, int d,
                               void* stream) {
  const Args a{msg, static_cast<const int*>(dst),
               static_cast<const int*>(indptr), static_cast<float*>(out),
               static_cast<float*>(carry), n_rows, n_edges, d};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = msg_is_bf16 ? launch<__nv_bfloat16>(a, s)
                                      : launch<float>(a, s);
  return static_cast<int>(err);
}

extern "C" const char* kgc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
