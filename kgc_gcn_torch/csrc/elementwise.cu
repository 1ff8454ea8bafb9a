// Kernels K4a and K4b of the port: the MGCN aggregation's one-pass message
// compose (forward) and cotangent products (backward), ew_impl=pallas.
//
//   K4a: msg      = (xgn * rg) * etab                        -> out type
//   K4b: contrib  = (gdn * rg) * etab                        -> out type
//        d_rel_in = (gdn * xg) * etab                        -> out type
//        d_etab   = (gdn * xg) * rg                          -> float32
//
// Every operand is an (E, d) float32 array, contiguous; the out type is
// float32 or bfloat16 (rounded to nearest even).  Replaces the TPU kernels
// kgc_gcn_tpu/ops/elementwise_pallas.py:_fwd_kernel (called through
// compose_msg_pad) and :_bwd_kernel (called through bwd_products), without
// their 128-lane output padding: the port writes (E, d).
//
// Bound: memory.  K4a reads 3 arrays of E*d floats and writes 1, K4b reads 4
// and writes 3; two or three multiplies per element are far below the card's
// balance of operations per byte.  The design moves every byte once:
//   * the arrays are elementwise, so they are walked flattened as (E*d,) and
//     the row width d does not matter;
//   * each thread takes 4 consecutive elements: float4 loads and stores, or
//     one 8-byte store of 4 packed bfloat16 values; a grid-stride loop over a
//     grid sized to fill the 132 SMs at full occupancy;
//   * the (E*d) % 4 tail elements take a scalar path, and so does the whole
//     array when any pointer is not 16-byte aligned (a view at an odd row
//     offset, where d is not a multiple of 4).
// The products are the same float32 multiplies, in the same order, as the
// plain version's, each rounded once (__fmul_rn; with no add there is
// nothing to contract), and the bfloat16 rounding is the same, so kernel and
// plain version agree to the bit on any input.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;   // 8 blocks of 256 threads fill an SM

struct alignas(8) Bf16x4 {
  __nv_bfloat162 lo, hi;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(mul(a.x, b.x), mul(a.y, b.y), mul(a.z, b.z),
                     mul(a.w, b.w));
}

__device__ __forceinline__ float4 load4(const float* __restrict__ p, int64_t i4) {
  return reinterpret_cast<const float4*>(p)[i4];
}

__device__ __forceinline__ void store1(float* out, int64_t i, float v) {
  out[i] = v;
}
__device__ __forceinline__ void store1(__nv_bfloat16* out, int64_t i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store4(float* out, int64_t i4, float4 v) {
  reinterpret_cast<float4*>(out)[i4] = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, int64_t i4, float4 v) {
  Bf16x4 p;
  p.lo = __floats2bfloat162_rn(v.x, v.y);   // .x at the lower address
  p.hi = __floats2bfloat162_rn(v.z, v.w);
  reinterpret_cast<Bf16x4*>(out)[i4] = p;
}

template <typename Out, bool kVec>
__global__ void __launch_bounds__(kThreads)
compose_kernel(const float* __restrict__ xgn, const float* __restrict__ rg,
               const float* __restrict__ etab, Out* __restrict__ out,
               int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t done = 0;
  if (kVec) {
    const int64_t n4 = n >> 2;
    for (int64_t i = tid; i < n4; i += stride) {
      store4(out, i, mul4(mul4(load4(xgn, i), load4(rg, i)), load4(etab, i)));
    }
    done = n4 << 2;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    store1(out, i, mul(mul(xgn[i], rg[i]), etab[i]));
  }
}

template <typename Out, bool kVec>
__global__ void __launch_bounds__(kThreads)
bwd_products_kernel(const float* __restrict__ gdn, const float* __restrict__ xg,
                    const float* __restrict__ rg,
                    const float* __restrict__ etab, Out* __restrict__ contrib,
                    Out* __restrict__ d_rel_in, float* __restrict__ d_etab,
                    int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t done = 0;
  if (kVec) {
    const int64_t n4 = n >> 2;
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 g = load4(gdn, i), r = load4(rg, i), t = load4(etab, i);
      const float4 gx = mul4(g, load4(xg, i));
      store4(contrib, i, mul4(mul4(g, r), t));
      store4(d_rel_in, i, mul4(gx, t));
      store4(d_etab, i, mul4(gx, r));
    }
    done = n4 << 2;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    const float g = gdn[i], r = rg[i], t = etab[i];
    const float gx = mul(g, xg[i]);
    store1(contrib, i, mul(mul(g, r), t));
    store1(d_rel_in, i, mul(gx, t));
    d_etab[i] = mul(gx, r);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int blocks_for(int64_t items) {
  const int64_t b = (items + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

template <typename Out>
cudaError_t launch_compose(const void* xgn, const void* rg, const void* etab,
                           void* out, int64_t n, cudaStream_t stream) {
  const float* a = static_cast<const float*>(xgn);
  const float* b = static_cast<const float*>(rg);
  const float* c = static_cast<const float*>(etab);
  Out* o = static_cast<Out*>(out);
  if (aligned16(xgn) && aligned16(rg) && aligned16(etab) && aligned16(out)) {
    compose_kernel<Out, true><<<blocks_for(n >> 2), kThreads, 0, stream>>>(
        a, b, c, o, n);
  } else {
    compose_kernel<Out, false><<<blocks_for(n), kThreads, 0, stream>>>(
        a, b, c, o, n);
  }
  return cudaGetLastError();
}

template <typename Out>
cudaError_t launch_bwd(const void* gdn, const void* xg, const void* rg,
                       const void* etab, void* contrib, void* d_rel_in,
                       void* d_etab, int64_t n, cudaStream_t stream) {
  const float* g = static_cast<const float*>(gdn);
  const float* x = static_cast<const float*>(xg);
  const float* r = static_cast<const float*>(rg);
  const float* t = static_cast<const float*>(etab);
  Out* c = static_cast<Out*>(contrib);
  Out* dr = static_cast<Out*>(d_rel_in);
  float* de = static_cast<float*>(d_etab);
  if (aligned16(gdn) && aligned16(xg) && aligned16(rg) && aligned16(etab) &&
      aligned16(contrib) && aligned16(d_rel_in) && aligned16(d_etab)) {
    bwd_products_kernel<Out, true><<<blocks_for(n >> 2), kThreads, 0, stream>>>(
        g, x, r, t, c, dr, de, n);
  } else {
    bwd_products_kernel<Out, false><<<blocks_for(n), kThreads, 0, stream>>>(
        g, x, r, t, c, dr, de, n);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches K4a on `stream` over n = E*d elements; returns the cudaError_t of
// the launch (0: success).  The caller guarantees n > 0 and owns every buffer.
extern "C" int kgc_compose_msg(const void* xgn, const void* rg,
                               const void* etab, void* out, int out_is_bf16,
                               int64_t n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_is_bf16 ? launch_compose<__nv_bfloat16>(xgn, rg, etab, out, n, s)
                  : launch_compose<float>(xgn, rg, etab, out, n, s);
  return static_cast<int>(err);
}

// Launches K4b on `stream` over n = E*d elements; contrib and d_rel_in are
// bfloat16 when out_is_bf16, d_etab is always float32.
extern "C" int kgc_bwd_products(const void* gdn, const void* xg,
                                const void* rg, const void* etab,
                                void* contrib, void* d_rel_in, void* d_etab,
                                int out_is_bf16, int64_t n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_is_bf16
          ? launch_bwd<__nv_bfloat16>(gdn, xg, rg, etab, contrib, d_rel_in,
                                      d_etab, n, s)
          : launch_bwd<float>(gdn, xg, rg, etab, contrib, d_rel_in, d_etab,
                              n, s);
  return static_cast<int>(err);
}
