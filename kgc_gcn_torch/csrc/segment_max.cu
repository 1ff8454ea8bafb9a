// Kernel K5 of the port: sorted CSR segment-max.
//
//   out[r, h] = max over indptr[r] <= e < indptr[r+1] of logits[e, h]
//
// logits is (E, H) float32, indptr (n_rows+1,) int32 over edges sorted by
// destination row, out (n_rows, H) float32; rows with no edges get -inf (the
// identity of max, as jax.ops.segment_max gives).  Replaces the TPU kernel
// kgc_gcn_tpu/ops/spmm_pallas.py:_seg_max_kernel (called through
// segment_max_sorted), which masks a (tile_n, tile_e) dst-match matrix and
// reduces each head across lanes because a max has no one-hot matmul form.
// None of that carries over to the card.
//
// Bound: memory.  Each logit is read once, indptr once and each output
// element written once, 4*E*H + 4*(n_rows+1) + 4*n_rows*H bytes, against
// one comparison per logit.  The design reads every byte that once:
//   * one warp owns one destination row; its lanes stride over the row's
//     edges (edge e0 + lane + 32k) and each keeps a running max per head in
//     registers, so a hub row is spread over 32 lanes instead of walked by
//     one;
//   * an edge's H logits are contiguous: where H is a multiple of 4 (and the
//     base is 16-byte aligned) each lane reads them as float4 vectors, so at
//     H = 4 a warp reads 512 contiguous bytes per step;
//   * a __shfl_xor_sync butterfly then reduces each head across the warp and
//     one lane per head writes it: one write per output element;
//   * heads beyond what registers hold run in chunks of kChunk, each chunk
//     walking the row again;
//   * edges are sorted by destination, so no two warps write the same row:
//     no atomics, no memset (empty rows write their -inf), no shared memory.
// A max is exact in any order, so the result equals any other max of the
// same values bit for bit.
//
// NaN: a NaN logit wins (max(x, NaN) = NaN), as in torch's "amax" reduction
// and jnp.maximum; plain fmaxf would drop it.  The logits on the RGAT path
// are finite or -inf.  Of -0.0 and +0.0 either may come out.
//
// The kernel does not read the destination ids; it asserts on the device that
// each row's range lies inside [0, E], as K1 does.

#include <cassert>
#include <cstdint>
#include <math_constants.h>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

// max that keeps a NaN of either operand
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <int kChunk, bool kVec4>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_max_kernel(const float* __restrict__ logits,
                   const int* __restrict__ indptr, float* __restrict__ out,
                   int n_rows, int n_edges, int h) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;   // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int e0 = indptr[row];
  const int e1 = indptr[row + 1];
  assert(0 <= e0 && e0 <= e1 && e1 <= n_edges);
  float* o = out + static_cast<int64_t>(row) * h;

  for (int c0 = 0; c0 < h; c0 += kChunk) {
    float acc[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) acc[j] = -CUDART_INF_F;

#pragma unroll 2
    for (int e = e0 + lane; e < e1; e += 32) {
      const float* p = logits + static_cast<int64_t>(e) * h + c0;
      if (kVec4) {
#pragma unroll
        for (int j = 0; j < kChunk; j += 4) {
          if (c0 + j < h) {
            const float4 v = *reinterpret_cast<const float4*>(p + j);
            acc[j] = nan_max(acc[j], v.x);
            acc[j + 1] = nan_max(acc[j + 1], v.y);
            acc[j + 2] = nan_max(acc[j + 2], v.z);
            acc[j + 3] = nan_max(acc[j + 3], v.w);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (c0 + j < h) acc[j] = nan_max(acc[j], p[j]);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[j] = nan_max(acc[j], __shfl_xor_sync(0xffffffffu, acc[j], off));
      }
    }
    // every lane now holds the row's maxima; lane j writes head c0 + j
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (lane == j && c0 + j < h) o[c0 + j] = acc[j];
    }
  }
}

template <int kChunk, bool kVec4>
cudaError_t launch(const float* logits, const int* indptr, float* out,
                   int n_rows, int n_edges, int h, cudaStream_t stream) {
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  segment_max_kernel<kChunk, kVec4><<<grid, block, 0, stream>>>(
      logits, indptr, out, n_rows, n_edges, h);
  return cudaGetLastError();
}

}  // namespace

// Launches K5 on `stream`; returns the cudaError_t of the launch (0: success).
// The caller guarantees n_rows > 0 and h > 0 and owns every buffer.
extern "C" int kgc_segment_max(const void* logits, const void* indptr,
                               void* out, int n_rows, int n_edges, int h,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(logits);
  const int* p = static_cast<const int*>(indptr);
  float* o = static_cast<float*>(out);
  const bool vec4 =
      h % 4 == 0 && (reinterpret_cast<uintptr_t>(logits) & 15) == 0;
  cudaError_t err;
  if (h <= 4) {
    err = vec4 ? launch<4, true>(l, p, o, n_rows, n_edges, h, s)
               : launch<4, false>(l, p, o, n_rows, n_edges, h, s);
  } else {
    err = vec4 ? launch<16, true>(l, p, o, n_rows, n_edges, h, s)
               : launch<16, false>(l, p, o, n_rows, n_edges, h, s);
  }
  return static_cast<int>(err);
}
