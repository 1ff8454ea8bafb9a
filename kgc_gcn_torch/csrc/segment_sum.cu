// Kernel K1 of the port: sorted CSR segment-sum.
//
//   out[r, :] = sum over indptr[r] <= e < indptr[r+1] of msg[e, :]
//
// msg is (E, D) float32 or bfloat16, indptr (n_rows+1,) int32 over edges
// sorted by destination row, out (n_rows, D) float32; rows with no edges get
// zeros.  Replaces the TPU kernel kgc_gcn_tpu/ops/spmm_pallas.py:_seg_kernel
// (called through segment_sum_pallas), without its TPU-only parts: the lane
// padding, the one-hot matmul and the hi/lo bf16 split.
//
// Bound: memory.  The least traffic is each message read once, indptr read
// once and each output row written once,
//   E*D*bytes(msg) + 4*(n_rows+1) + 4*n_rows*D bytes,
// against one add per message element, far below the card's balance of
// operations per byte.  The design reads every byte exactly that once:
//   * one warp owns one destination row and walks its CSR edge range; lane l
//     accumulates columns l, l+32, ... in float32 registers, so each edge's
//     row is one coalesced read by the warp and each output row one write;
//   * edges are sorted by destination, so no two warps write the same row:
//     no atomics, no memset (empty rows write their zeros) and the sum order
//     is fixed, so results are deterministic;
//   * the edge loop is unrolled so that several edges' loads are in flight.
// Known limit: a hub row with thousands of edges runs serially in one warp.
//
// The kernel does not read the destination ids; it asserts on the device that
// each row's range lies inside [0, E], so a bad indptr faults instead of
// reading out of bounds, without a host sync on every launch.

#include <cassert>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxColsPerLane = 8;
constexpr int kColChunk = 32 * kMaxColsPerLane;   // columns per blockIdx.y

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int kColsPerLane>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_kernel(const T* __restrict__ msg, const int* __restrict__ indptr,
                   float* __restrict__ out, int n_rows, int n_edges, int d) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int col0 = blockIdx.y * kColChunk + (threadIdx.x & 31);
  const int e0 = indptr[row];
  const int e1 = indptr[row + 1];
  assert(0 <= e0 && e0 <= e1 && e1 <= n_edges);

  float acc[kColsPerLane];
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) acc[c] = 0.f;

#pragma unroll 4
  for (int e = e0; e < e1; ++e) {
    const T* m = msg + static_cast<int64_t>(e) * d;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int col = col0 + 32 * c;
      if (col < d) acc[c] += widen(m[col]);
    }
  }

  float* o = out + static_cast<int64_t>(row) * d;
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) {
    const int col = col0 + 32 * c;
    if (col < d) o[col] = acc[c];
  }
}

template <typename T>
cudaError_t launch(const void* msg, const void* indptr, void* out, int n_rows,
                   int n_edges, int d, cudaStream_t stream) {
  const int width = d < kColChunk ? d : kColChunk;
  const int cols_per_lane = (width + 31) / 32;
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (d + kColChunk - 1) / kColChunk);
  const dim3 block(kWarpsPerBlock * 32);
  const T* m = static_cast<const T*>(msg);
  const int* p = static_cast<const int*>(indptr);
  float* o = static_cast<float*>(out);
  if (cols_per_lane <= 1) {
    segment_sum_kernel<T, 1><<<grid, block, 0, stream>>>(m, p, o, n_rows, n_edges, d);
  } else if (cols_per_lane <= 2) {
    segment_sum_kernel<T, 2><<<grid, block, 0, stream>>>(m, p, o, n_rows, n_edges, d);
  } else if (cols_per_lane <= 4) {
    segment_sum_kernel<T, 4><<<grid, block, 0, stream>>>(m, p, o, n_rows, n_edges, d);
  } else {
    segment_sum_kernel<T, 8><<<grid, block, 0, stream>>>(m, p, o, n_rows, n_edges, d);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches K1 on `stream`; returns the cudaError_t of the launch (0: success).
// The caller guarantees n_rows > 0 and d > 0 and owns every buffer.
extern "C" int kgc_segment_sum(const void* msg, int msg_is_bf16,
                               const void* indptr, void* out, int n_rows,
                               int n_edges, int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      msg_is_bf16 ? launch<__nv_bfloat16>(msg, indptr, out, n_rows, n_edges, d, s)
                  : launch<float>(msg, indptr, out, n_rows, n_edges, d, s);
  return static_cast<int>(err);
}

extern "C" const char* kgc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
