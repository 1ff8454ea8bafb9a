// Kernels K2a and K2b of the port: the 1-vs-all score product fused with the
// dense term of the label-smoothed BCE, forward and backward.
//
//   s[b, n]  = h[b, :] . ent[n, :] + bias[n]                  (never stored)
//   K2a:  loss  = sum_{b<B, n<N} w[b] * (relu(s) - base*s + log1p(exp(-|s|)))
//   K2b:  dl    = (sigmoid(s) - base) * w[b] * g              (never stored)
//         d_ent = dl^T h  (N, d),  d_bias = sum_b dl  (N,),  d_h = dl ent  (B, d)
//
// h (B, d), ent (N, d), bias (N,), w (B,) and the scalar g are float32; all
// outputs are float32.  Replaces the TPU kernels
// kgc_gcn_tpu/ops/fused_loss.py:_fwd_kernel (K2a, called through
// _dense_loss_pallas) and :_bwd_kernel (K2b, through _dense_grads_pallas).
//
// Bound: operations.  At the training shape (B 128, d 200, N 40,943) K2a is
// one B x d x N product (2.1 GFLOP, 31 us at the card's 67 TFLOP/s float32
// rate outside the tensor cores) against 33 MB of traffic (10 us at
// 3.35 TB/s); K2b is three such products against 66 MB.  The design keeps the
// (B, N) score matrix out of device memory, which is the point of the TPU
// kernel, and is the simple float32 form (CUDA cores, FMA; TF32 stays off, as
// in the rest of the port):
//   * a score tile is a shared-memory tiled product: kBK-wide slices of the h
//     rows and of the entity rows are staged in shared memory and each thread
//     keeps a small register tile of scores; softplus and sigmoid are applied
//     to that register tile;
//   * the TPU kernels carry their sums (K2a's scalar, K2b's (B, d) d_h) from
//     one grid step to the next, which Hopper's unordered blocks cannot do.
//     Here every block writes its partial sum and a second pass adds the
//     partials in a fixed order: no atomics, and the result is deterministic.
//     d_ent and d_bias are owned entity tile by entity tile and need no
//     reduction;
//   * K2b is one d_ent/d_bias kernel over entity tiles (all B rows in the
//     block, the dl tile in shared memory) and one d_h kernel over (row tile,
//     run of entity tiles) blocks, reduced over the runs; both recompute the
//     score tile, so K2b does four products' work where the bound counts
//     three;
//   * the ragged last entity tile and the last row tile are masked by
//     bounds checks on every load and store: no row beyond N or B is read.
// Gradient columns run in windows of up to 256 (32 lanes x 8 columns each);
// a wider d runs several windows and recomputes the scores in each.
// Later work: wgmma / TMA, or a split-precision tensor-core scheme.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;              // depth of one staged slice
// K2a: 64 rows x 64 entities per block, 4 x 4 scores per thread
constexpr int kLossRows = 64;
constexpr int kLossTileN = 64;
// K2b d_ent / d_bias: 32 entities per block, rows in chunks of 64
constexpr int kEntTileN = 32;
constexpr int kEntRows = 64;
// K2b d_h: 32 rows per block, entity tiles of 32
constexpr int kDhRows = 32;
constexpr int kDhTileN = 32;
constexpr int kWindow = 256;         // gradient columns per window

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stages columns [k0, k0 + kBK) of rows [r0, r0 + ROWS) of a row-major
// (n_rows, d) matrix as dst[k][r]; out-of-range entries are zeros.
template <int ROWS, int LD>
__device__ __forceinline__ void stage(const float* __restrict__ src, int r0,
                                      int n_rows, int d, int k0,
                                      float (*dst)[LD]) {
  for (int i = threadIdx.x; i < ROWS * kBK; i += kThreads) {
    const int r = i / kBK, k = i % kBK;
    const int row = r0 + r, col = k0 + k;
    dst[k][r] = (row < n_rows && col < d)
                    ? src[static_cast<int64_t>(row) * d + col] : 0.f;
  }
}

// acc[i][j] += sum_k a[k][ar + i] * e[k][ec + j] over the whole depth d,
// staging both operands slice by slice (all threads of the block call it).
template <int AR, int EC, int ROWS, int COLS, int LDA, int LDE>
__device__ __forceinline__ void score_tile(
    const float* __restrict__ h, int r0, int b, const float* __restrict__ ent,
    int n0, int n, int d, float (*as)[LDA], float (*es)[LDE], int ar, int ec,
    float (&acc)[AR][EC]) {
  for (int k0 = 0; k0 < d; k0 += kBK) {
    stage<ROWS>(h, r0, b, d, k0, as);
    stage<COLS>(ent, n0, n, d, k0, es);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[AR], e[EC];
#pragma unroll
      for (int i = 0; i < AR; ++i) a[i] = as[k][ar + i];
#pragma unroll
      for (int j = 0; j < EC; ++j) e[j] = es[k][ec + j];
#pragma unroll
      for (int i = 0; i < AR; ++i)
#pragma unroll
        for (int j = 0; j < EC; ++j) acc[i][j] = fmaf(a[i], e[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float bce_term(float s, float base) {
  return fmaxf(s, 0.f) - base * s + log1pf(expf(-fabsf(s)));
}

__device__ __forceinline__ float dl_of(float s, float base, float wg) {
  return (1.f / (1.f + expf(-s)) - base) * wg;
}

// ---------------------------------------------------------------- K2a

__global__ void __launch_bounds__(kThreads)
loss_partials_kernel(const float* __restrict__ h, const float* __restrict__ ent,
                     const float* __restrict__ bias, const float* __restrict__ w,
                     float base, float* __restrict__ partials, int b, int n,
                     int d) {
  __shared__ float hs[kBK][kLossRows + 4];
  __shared__ float es[kBK][kLossTileN + 4];
  __shared__ float red[kThreads / 32];
  const int n0 = blockIdx.x * kLossTileN;
  const int r0 = blockIdx.y * kLossRows;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  score_tile<4, 4, kLossRows, kLossTileN>(h, r0, b, ent, n0, n, d, hs, es,
                                          ty * 4, tx * 4, acc);
  float local = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (row < b && col < n) local += bce_term(acc[i][j] + bias[col], base) * w[row];
    }
  }
  local = warp_sum(local);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) t += red[i];
    partials[blockIdx.y * gridDim.x + blockIdx.x] = t;
  }
}

// One block adds the partials in a fixed order.
__global__ void __launch_bounds__(1024)
sum_partials_kernel(const float* __restrict__ partials, int n_part,
                    float* __restrict__ out) {
  __shared__ float red[32];
  float t = 0.f;
  for (int i = threadIdx.x; i < n_part; i += blockDim.x) t += partials[i];
  t = warp_sum(t);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = t;
  __syncthreads();
  if (threadIdx.x < 32) {
    t = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : 0.f;
    t = warp_sum(t);
    if (threadIdx.x == 0) *out = t;
  }
}

// ---------------------------------------------------------------- K2b

// d_ent[n0:n0+32, col0:col0+window] and (first window) d_bias[n0:n0+32]:
// the block walks all B rows in chunks of 64, builds the chunk's dl tile in
// shared memory and adds dl^T h into registers.
template <int kCols>
__global__ void __launch_bounds__(kThreads)
dent_kernel(const float* __restrict__ g, const float* __restrict__ h,
            const float* __restrict__ ent, const float* __restrict__ bias,
            const float* __restrict__ w, float base, float* __restrict__ d_ent,
            float* __restrict__ d_bias, int b, int n, int d, int col0,
            int window) {
  __shared__ float hs[kBK][kEntRows + 4];
  __shared__ float es[kBK][kEntTileN + 4];
  __shared__ __align__(16) float dls[kEntRows][kEntTileN + 4];
  const int n0 = blockIdx.x * kEntTileN;
  const float gs = *g;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;         // scores: 2 x 4
  const int lane = threadIdx.x & 31, eg = threadIdx.x >> 5;     // grads: 4 x kCols
  float acc[4][kCols] = {};
  float bias_acc = 0.f;            // thread t < 32 owns d_bias[n0 + t]
  for (int r0 = 0; r0 < b; r0 += kEntRows) {
    float s[2][4] = {};
    score_tile<2, 4, kEntRows, kEntTileN>(h, r0, b, ent, n0, n, d, hs, es,
                                          ty * 2, tx * 4, s);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + ty * 2 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        dls[ty * 2 + i][tx * 4 + j] =
            (row < b && col < n) ? dl_of(s[i][j] + bias[col], base, w[row] * gs)
                                 : 0.f;
      }
    }
    __syncthreads();
    if (col0 == 0 && threadIdx.x < kEntTileN) {
      for (int r = 0; r < kEntRows; ++r) bias_acc += dls[r][threadIdx.x];
    }
    const int rows = min(kEntRows, b - r0);
    for (int r = 0; r < rows; ++r) {
      const float* hr = h + static_cast<int64_t>(r0 + r) * d + col0;
      float hv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        hv[c] = col < window ? __ldg(hr + col) : 0.f;
      }
      const float4 dl4 = *reinterpret_cast<const float4*>(&dls[r][eg * 4]);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        acc[0][c] = fmaf(dl4.x, hv[c], acc[0][c]);
        acc[1][c] = fmaf(dl4.y, hv[c], acc[1][c]);
        acc[2][c] = fmaf(dl4.z, hv[c], acc[2][c]);
        acc[3][c] = fmaf(dl4.w, hv[c], acc[3][c]);
      }
    }
    __syncthreads();               // dls is rewritten by the next chunk
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = n0 + eg * 4 + e;
    if (row >= n) continue;
    float* out = d_ent + static_cast<int64_t>(row) * d + col0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < window) out[col] = acc[e][c];
    }
  }
  if (col0 == 0 && threadIdx.x < kEntTileN && n0 + threadIdx.x < n) {
    d_bias[n0 + threadIdx.x] = bias_acc;
  }
}

// Partial d_h over one run of entity tiles: block (x, y) owns rows
// [32x, 32x + 32) and entity tiles [y * tiles_per_split, ...), and writes its
// (32, window) partial to scratch[y] (shape (splits, B, window)).
template <int kCols>
__global__ void __launch_bounds__(kThreads)
dh_partials_kernel(const float* __restrict__ g, const float* __restrict__ h,
                   const float* __restrict__ ent, const float* __restrict__ bias,
                   const float* __restrict__ w, float base,
                   float* __restrict__ scratch, int b, int n, int d, int col0,
                   int window, int tiles_per_split) {
  __shared__ float hs[kBK][kDhRows + 4];
  __shared__ float es[kBK][kDhTileN + 4];
  __shared__ float dls[kDhRows][kDhTileN + 1];
  const int r0 = blockIdx.x * kDhRows;
  const int n_tiles = (n + kDhTileN - 1) / kDhTileN;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);
  const float gs = *g;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;       // scores: 2 x 2
  const int lane = threadIdx.x & 31, rg = threadIdx.x >> 5;     // grads: 4 x kCols
  float acc[4][kCols] = {};
  for (int tile = t0; tile < t1; ++tile) {
    const int n0 = tile * kDhTileN;
    float s[2][2] = {};
    score_tile<2, 2, kDhRows, kDhTileN>(h, r0, b, ent, n0, n, d, hs, es,
                                        ty * 2, tx * 2, s);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + ty * 2 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n0 + tx * 2 + j;
        dls[ty * 2 + i][tx * 2 + j] =
            (row < b && col < n) ? dl_of(s[i][j] + bias[col], base, w[row] * gs)
                                 : 0.f;
      }
    }
    __syncthreads();
    const int ents = min(kDhTileN, n - n0);
    for (int e = 0; e < ents; ++e) {
      const float* er = ent + static_cast<int64_t>(n0 + e) * d + col0;
      float ev[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        ev[c] = col < window ? __ldg(er + col) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dl = dls[rg * 4 + i][e];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(dl, ev[c], acc[i][c]);
      }
    }
    __syncthreads();               // dls is rewritten by the next tile
  }
  float* part = scratch + static_cast<int64_t>(blockIdx.y) * b * window;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + rg * 4 + i;
    if (row >= b) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < window) part[static_cast<int64_t>(row) * window + col] = acc[i][c];
    }
  }
}

// d_h[:, col0:col0+window] = sum over the splits, in split order.
__global__ void __launch_bounds__(kThreads)
dh_reduce_kernel(const float* __restrict__ scratch, float* __restrict__ d_h,
                 int b, int d, int col0, int window, int splits) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t per_split = static_cast<int64_t>(b) * window;
  if (i >= per_split) return;
  float t = 0.f;
  for (int s = 0; s < splits; ++s) t += scratch[s * per_split + i];
  const int row = static_cast<int>(i / window), col = static_cast<int>(i % window);
  d_h[static_cast<int64_t>(row) * d + col0 + col] = t;
}

template <int kCols>
cudaError_t launch_grads(const float* g, const float* h, const float* ent,
                         const float* bias, const float* w, float base,
                         float* d_h, float* d_ent, float* d_bias, float* scratch,
                         int b, int n, int d, int col0, int window, int splits,
                         int tiles_per_split, cudaStream_t stream) {
  dent_kernel<kCols><<<(n + kEntTileN - 1) / kEntTileN, kThreads, 0, stream>>>(
      g, h, ent, bias, w, base, d_ent, d_bias, b, n, d, col0, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((b + kDhRows - 1) / kDhRows, splits);
  dh_partials_kernel<kCols><<<grid, kThreads, 0, stream>>>(
      g, h, ent, bias, w, base, scratch, b, n, d, col0, window, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = static_cast<int64_t>(b) * window;
  dh_reduce_kernel<<<static_cast<int>((total + kThreads - 1) / kThreads),
                     kThreads, 0, stream>>>(scratch, d_h, b, d, col0, window,
                                            splits);
  return cudaGetLastError();
}

}  // namespace

// Number of per-block partial sums K2a writes (the caller's scratch size).
extern "C" int kgc_fused_bce_loss_partials(int b, int n) {
  return ((n + kLossTileN - 1) / kLossTileN) * ((b + kLossRows - 1) / kLossRows);
}

// Launches K2a on `stream`; *out receives the sum.  Returns the cudaError_t
// of the launches (0: success).  The caller guarantees b, n > 0, owns every
// buffer and sizes `partials` by kgc_fused_bce_loss_partials.
extern "C" int kgc_fused_bce_loss(const void* h, const void* ent,
                                  const void* bias, const void* w, float base,
                                  void* partials, void* out, int b, int n,
                                  int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kLossTileN - 1) / kLossTileN, (b + kLossRows - 1) / kLossRows);
  loss_partials_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(ent),
      static_cast<const float*>(bias), static_cast<const float*>(w), base,
      static_cast<float*>(partials), b, n, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<1, 1024, 0, s>>>(static_cast<const float*>(partials),
                                         kgc_fused_bce_loss_partials(b, n),
                                         static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Launches K2b on `stream`: d_h, d_ent and d_bias of the dense term scaled by
// the device scalar *g.  `scratch` holds splits * b * min(d, 256) floats;
// entity tiles of 32 are split into `splits` runs of `tiles_per_split` for
// the d_h partials.  The caller guarantees b, n, d > 0 and owns every buffer.
extern "C" int kgc_fused_bce_grads(const void* g, const void* h,
                                   const void* ent, const void* bias,
                                   const void* w, float base, void* d_h,
                                   void* d_ent, void* d_bias, void* scratch,
                                   int b, int n, int d, int splits,
                                   int tiles_per_split, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  const float* hp = static_cast<const float*>(h);
  const float* ep = static_cast<const float*>(ent);
  const float* bp = static_cast<const float*>(bias);
  const float* wp = static_cast<const float*>(w);
  float* dh = static_cast<float*>(d_h);
  float* de = static_cast<float*>(d_ent);
  float* db = static_cast<float*>(d_bias);
  float* sc = static_cast<float*>(scratch);
  for (int col0 = 0; col0 < d; col0 += kWindow) {
    const int window = d - col0 < kWindow ? d - col0 : kWindow;
    const int cols = (window + 31) / 32;
    cudaError_t err;
    if (cols <= 1) {
      err = launch_grads<1>(gp, hp, ep, bp, wp, base, dh, de, db, sc, b, n, d,
                            col0, window, splits, tiles_per_split, s);
    } else if (cols <= 2) {
      err = launch_grads<2>(gp, hp, ep, bp, wp, base, dh, de, db, sc, b, n, d,
                            col0, window, splits, tiles_per_split, s);
    } else if (cols <= 4) {
      err = launch_grads<4>(gp, hp, ep, bp, wp, base, dh, de, db, sc, b, n, d,
                            col0, window, splits, tiles_per_split, s);
    } else {
      err = launch_grads<8>(gp, hp, ep, bp, wp, base, dh, de, db, sc, b, n, d,
                            col0, window, splits, tiles_per_split, s);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
