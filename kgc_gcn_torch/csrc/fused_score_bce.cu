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
// Neither the (B, N) score matrix nor the (B, N) dl matrix reaches device
// memory, which is the point of the TPU kernels.
//
// Bound: operations.  At the training shape (B 128, d 200, N 40,943) K2a is
// one B x d x N product (2.1 GFLOP, 31 us at the card's 67 TFLOP/s float32
// rate outside the tensor cores) against 33 MB of traffic (10 us at
// 3.35 TB/s); K2b is three such products (6.29 GFLOP, 94 us) against 66 MB.
// Both run in float32 on the CUDA cores (FMA; TF32 stays off, as in the rest
// of the port).
//
// K2a: a score tile is a shared-memory tiled product (kBK-wide slices of the
// h rows and entity rows staged as dst[k][row], a 4 x 4 register tile of
// scores a thread); softplus is applied to the register tile, every block
// writes one partial sum and a second pass adds the partials in a fixed
// order.
//
// K2b: one pass over entity tiles, each score tile computed once.
//   * Block x owns the contiguous run of 64-entity tiles
//     [x * tiles_per_block, ...) and all B rows, in chunks of 128; the
//     wrapper sizes the runs so that there are about as many blocks, and so
//     d_h partials, as the card has SMs (ops/fused_loss.py:grads_schedule;
//     128 blocks of 5 tiles at the WN18RR shape).
//   * Per (row chunk, tile): the score tile S (128 x 64, depth d) is a
//     register-tiled product, 4 rows x 8 entities a thread; it becomes the
//     dl tile, kept transposed in shared memory (dlT[e][r]); d_bias and
//     d_ent = dlT h of the tile go straight out (each tile has one owner, so
//     they need no reduction); dlT ent is added into the block's own d_h
//     partial: three products, S computed once.
//   * Operands: the chunk's h rows (once per chunk) and the tile's entity
//     rows arrive by 16-byte cp.async (4-byte where d or a base is no
//     multiple of 4 floats), zero-filled past B, N and d, so that rows
//     beyond N, which may hold anything, are never read.  They are stored
//     as float4 quads of 4 columns, quad-major (hs[kq][r], es[kq][e]), so
//     that the score product reads both operands K-major as LDS.128 and the
//     gradient products read 4 or 8 columns of a row as LDS.128.  Each
//     product is a 4 x 8 (d_h, S) or 8 x 4 (d_ent) register tile a thread,
//     12 LDS.128 per 128 FMAs, with no bank conflict within a quarter-warp.
//   * Stores write whole 32-byte sectors.  The d_h partial keeps each
//     unit's quads lane-interleaved (a warp's store is 512 contiguous
//     bytes), and the d_ent lanes of a pair take the two halves of one
//     sector.  Lanes that each write 16-byte halves of sectors of 32 rows
//     make these stores, not the products, take most of the time (0.45 ms
//     against 0.24 at the WN18RR shape; PERF.md §6).
//   * Columns run in windows of at most 248 (kMaxWindow): at d <= 248 (the
//     presets' 200) the whole row is resident, h is staged once per chunk,
//     and the next tile's entity rows are copied while the d_ent product
//     runs (it reads only h and dlT).  A wider d restages h and the tile
//     window by window: once for S, then again for the gradient windows,
//     last window first, and never recomputes S.
//   * Shared memory sets the residency: at d 200, 193,792 bytes
//     (16 * d/4 * (132 + 68) + 4 * 64 * 132), so one block of 256 threads an
//     SM (8 warps, 2 a scheduler), with up to 255 registers a thread.
//   * d_h is deterministic: each thread adds its d_h units tile after tile,
//     in order, into its block's partial (a read-add-write of the block's
//     own slice, which stays in L2), and a second launch adds the partials
//     in block order (8 warps over interleaved partials, then the 8 warp
//     sums in warp order).  No atomics: two calls give the same bits.
//     d_ent and d_bias of a tile are written by its owner, chunk after
//     chunk.
// What holds it back (clock64 stamps, PERF.md §6): the three products run
// at about 2/3 of the FMA issue rate with two warps a scheduler, and 8 x 8
// tiles, which halve the shared-memory reads per FMA, ran no faster; the
// 400 d_ent and 800 d_h units of a tile do not divide evenly over 256
// threads; the dl step waits on its bias and row-weight loads.
// Later work: the tensor cores (wgmma, or a split 3xTF32 scheme) are a
// numerics question of their own.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;              // K2a: depth of one staged slice
// K2a: 64 rows x 64 entities per block, 4 x 4 scores per thread
constexpr int kLossRows = 64;
constexpr int kLossTileN = 64;
// K2b: rows of h per chunk, entities per tile, slot strides (padded by 4 so
// that the copies' 2 x 4-slot groups of a quarter-warp hit distinct banks)
constexpr int kGradRows = 128;
constexpr int kGradTileN = 64;
constexpr int kLdH = kGradRows + 4;  // float4 slots per quad of hs
constexpr int kLdE = kGradTileN + 4; // float4 slots per quad of es
constexpr int kLdL = kGradRows + 4;  // floats per row of dlT
constexpr int kMaxSmem = 232448;     // one block's opt-in maximum (227 KB)
constexpr int kMaxWindow = 248;      // widest window whose operands fit

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

__host__ __device__ inline int grads_smem_bytes(int window) {
  return 16 * (window / 4) * (kLdH + kLdE) + 4 * kGradTileN * kLdL;
}

// float4 slots of one block's d_h partial: 256 a (row chunk, window, column
// group of 8), rows padded to whole chunks of 128.
__host__ __device__ inline int64_t grads_partial_slots(int b, int window,
                                                       int n_windows) {
  return static_cast<int64_t>((b + kGradRows - 1) / kGradRows) * n_windows *
         (window / 8) * 256;
}

// 16- or 4-byte asynchronous copy; `valid` false copies nothing and fills
// the destination with zeros (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for all of this thread's copies.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts copying columns [col0, col0 + 4 * kqw) of rows [row0, row0 + R) of
// the row-major (n_rows, d) matrix src into quads dst[kq * ld + r].  A
// warp takes 4 rows x 8 quads at a time (128 contiguous bytes of each row);
// quads past n_rows or d are zero-filled without a read.  kVec: d and src
// are multiples of 4 floats, so a quad is all in or all out.
template <bool kVec, int R>
__device__ __forceinline__ void stage_quads(float4* dst, int ld,
                                            const float* __restrict__ src,
                                            int row0, int n_rows, int d,
                                            int col0, int kqw) {
  const int lane = threadIdx.x & 31;
  const int rr = lane & 3, kk = lane >> 2;
  for (int r = (threadIdx.x >> 5) * 4 + rr; r < R; r += kThreads / 8) {
    const int row = row0 + r;
    const bool row_ok = row < n_rows;
    const float* src_row = src + static_cast<int64_t>(row_ok ? row : 0) * d;
    for (int kq = kk; kq < kqw; kq += 8) {
      const int c = col0 + 4 * kq;
      float4* s = dst + kq * ld + r;
      if (kVec) {
        const bool ok = row_ok && c < d;
        cp_async16(s, ok ? src_row + c : src, ok);
      } else {
        float* sf = reinterpret_cast<float*>(s);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const bool ok = row_ok && c + t < d;
          cp_async4(sf + t, ok ? src_row + c + t : src, ok);
        }
      }
    }
  }
}

__device__ __forceinline__ float dot4(const float4& x, const float4& y,
                                      float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

// acc[0..7] += s * (lo, hi)
__device__ __forceinline__ void axpy8(float (&acc)[8], float s,
                                      const float4& lo, const float4& hi) {
  acc[0] = fmaf(s, lo.x, acc[0]);
  acc[1] = fmaf(s, lo.y, acc[1]);
  acc[2] = fmaf(s, lo.z, acc[2]);
  acc[3] = fmaf(s, lo.w, acc[3]);
  acc[4] = fmaf(s, hi.x, acc[4]);
  acc[5] = fmaf(s, hi.y, acc[5]);
  acc[6] = fmaf(s, hi.z, acc[6]);
  acc[7] = fmaf(s, hi.w, acc[7]);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Loads (stores) the 4 floats of a row from column c, or fewer where the row
// ends at `cols`; kVec: c and cols are multiples of 4, p 16-byte aligned.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* p, int c, int cols) {
  if (kVec) return c < cols ? *reinterpret_cast<const float4*>(p) : float4{};
  float v[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = c + t < cols ? p[t] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <bool kVec>
__device__ __forceinline__ void store4(float* p, int c, int cols,
                                       const float4& v) {
  if (kVec) {
    if (c < cols) *reinterpret_cast<float4*>(p) = v;
    return;
  }
  const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (c + t < cols) p[t] = a[t];
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// d_h partial, window `win`: unit (rg, cg) of a thread is rows 4rg..4rg+3
// of the chunk x window columns 8cg..8cg+7; a warp shares cg, so the
// entity quads are broadcasts and the dlT quads 32 consecutive slots.  The
// partial keeps the units' quads lane-interleaved, quad k of unit (rg, cg)
// at slot (unit_base + cg) * 256 + 32k + rg, so that each read and write
// of a warp is 512 contiguous bytes (rows past B hold zeros).  `first`:
// the block's first tile writes its partial; later tiles read, add and
// write it (this thread's own slots).
__device__ __forceinline__ void dh_window(const float* dlt, const float4* es,
                                          float4* part, int cg_n, bool first) {
  for (int u = threadIdx.x; u < 32 * cg_n; u += kThreads) {
    const int rg = u & 31, cg = u >> 5;
    float4* slot = part + cg * 256 + rg;
    float4 old[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      old[k] = first ? make_float4(0.f, 0.f, 0.f, 0.f) : slot[32 * k];
    float acc[4][8] = {};
    const float4* lp = reinterpret_cast<const float4*>(dlt) + rg;
    const float4* xp = es + 2 * cg * kLdE;
#pragma unroll 4
    for (int e = 0; e < kGradTileN; ++e) {
      const float4 l = lp[e * (kLdL / 4)];
      const float4 x0 = xp[e], x1 = xp[kLdE + e];
      axpy8(acc[0], l.x, x0, x1);
      axpy8(acc[1], l.y, x0, x1);
      axpy8(acc[2], l.z, x0, x1);
      axpy8(acc[3], l.w, x0, x1);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float* a = acc[k >> 1] + 4 * (k & 1);
      float4 v = make_float4(a[0], a[1], a[2], a[3]);
      add4(v, old[k]);
      slot[32 * k] = v;
    }
  }
}

// d_ent (and, from the second chunk, its read-add-write), window
// [col0, col0 + 8 * cg_n): unit (eg, q) of a thread is entities eg + 8i
// (i < 8) of the tile x the 4 columns of quad q, over the chunk's 128 rows
// in quads (dlT[e][4rq..4rq+3] as one LDS.128).  Lanes 2m and 2m + 1 take
// quads 2p and 2p + 1 of one entity row, so each pair stores one whole
// 32-byte sector.
template <bool kVec>
__device__ __forceinline__ void dent_window(const float* dlt, const float4* hs,
                                            float* __restrict__ d_ent, int n0,
                                            int n, int d, int col0, int cg_n,
                                            bool add) {
  for (int u = threadIdx.x; u < 16 * cg_n; u += kThreads) {
    const int eg = (u >> 1) & 7, q = 2 * (u >> 4) + (u & 1);
    const int c = col0 + 4 * q;
    float4 old[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = n0 + eg + 8 * i;
      old[i] = add && e < n
                   ? load4<kVec>(d_ent + static_cast<int64_t>(e) * d + c, c, d)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float acc[8][4] = {};
    const float4* yp = hs + q * kLdH;
    const float4* lp = reinterpret_cast<const float4*>(dlt) + eg * (kLdL / 4);
#pragma unroll 2
    for (int rq = 0; rq < kGradRows / 4; ++rq) {
      float4 l[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) l[i] = lp[8 * i * (kLdL / 4) + rq];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 y = yp[4 * rq + kk];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float s = comp(l[i], kk);
          acc[i][0] = fmaf(s, y.x, acc[i][0]);
          acc[i][1] = fmaf(s, y.y, acc[i][1]);
          acc[i][2] = fmaf(s, y.z, acc[i][2]);
          acc[i][3] = fmaf(s, y.w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = n0 + eg + 8 * i;
      if (e >= n) continue;
      float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      add4(v, old[i]);
      store4<kVec>(d_ent + static_cast<int64_t>(e) * d + c, c, d, v);
    }
  }
}

// The pass over entity tiles (see the note at the top).  partials holds
// gridDim.x partials of grads_partial_slots(b, window, n_windows) float4
// slots each.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
grads_kernel(const float* __restrict__ g, const float* __restrict__ h,
             const float* __restrict__ ent, const float* __restrict__ bias,
             const float* __restrict__ w, float base, float* __restrict__ d_ent,
             float* __restrict__ d_bias, float* __restrict__ partials, int b,
             int n, int d, int tiles_per_block, int window, int n_windows) {
  extern __shared__ float4 smem4[];
  const int kqw = window / 4, cg_n = window / 8;
  float4* hs = smem4;                                     // [kqw][kLdH]
  float4* es = hs + kqw * kLdH;                           // [kqw][kLdE]
  float* dlt = reinterpret_cast<float*>(es + kqw * kLdE); // [kGradTileN][kLdL]
  const int n_tiles = (n + kGradTileN - 1) / kGradTileN;
  const int t_begin = blockIdx.x * tiles_per_block;
  const int t_end = min(t_begin + tiles_per_block, n_tiles);
  float4* part = reinterpret_cast<float4*>(partials) +
                 blockIdx.x * grads_partial_slots(b, window, n_windows);
  const float gs = *g;
  const bool one_window = n_windows == 1;
  const int eg = threadIdx.x & 7, rg = threadIdx.x >> 3;  // score tile owner

  for (int r0 = 0; r0 < b; r0 += kGradRows) {
    if (one_window) {
      stage_quads<kVec, kGradRows>(hs, kLdH, h, r0, b, d, 0, kqw);
      stage_quads<kVec, kGradTileN>(es, kLdE, ent, t_begin * kGradTileN, n, d,
                                    0, kqw);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }
    for (int t = t_begin; t < t_end; ++t) {
      const int n0 = t * kGradTileN;
      // 1. S: rows 4rg..4rg+3 x entities eg + 8j, K-major quads
      float acc[4][8] = {};
      for (int win = 0; win < n_windows; ++win) {
        if (!one_window) {
          stage_quads<kVec, kGradRows>(hs, kLdH, h, r0, b, d, win * window, kqw);
          stage_quads<kVec, kGradTileN>(es, kLdE, ent, n0, n, d, win * window,
                                        kqw);
          cp_async_commit();
          cp_async_wait_all();
          __syncthreads();
        }
        const float4* hp = hs + 4 * rg;
        const float4* ep = es + eg;
#pragma unroll 2
        for (int kq = 0; kq < kqw; ++kq) {
          float4 a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = hp[kq * kLdH + i];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 e = ep[kq * kLdE + 8 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = dot4(a[i], e, acc[i][j]);
          }
        }
        if (!one_window && win + 1 < n_windows) __syncthreads();
      }
      // dl tile, transposed: dlT[e][r]; zero past B and N
      {
        float wg[4];
        bool row_ok[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r0 + 4 * rg + i;
          row_ok[i] = row < b;
          wg[i] = row_ok[i] ? __ldg(w + row) * gs : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int e = n0 + eg + 8 * j;
          const bool ok = e < n;
          const float bj = ok ? __ldg(bias + e) : 0.f;
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = ok && row_ok[i] ? dl_of(acc[i][j] + bj, base, wg[i]) : 0.f;
          *reinterpret_cast<float4*>(dlt + (eg + 8 * j) * kLdL + 4 * rg) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
      __syncthreads();
      // d_bias of the tile, summed over the chunk's rows in order
      if (threadIdx.x < kGradTileN && n0 + threadIdx.x < n) {
        const float4* row = reinterpret_cast<const float4*>(dlt + threadIdx.x * kLdL);
        float s = 0.f;
        for (int q = 0; q < kGradRows / 4; ++q) {
          const float4 v = row[q];
          s += v.x;
          s += v.y;
          s += v.z;
          s += v.w;
        }
        float* out = d_bias + n0 + threadIdx.x;
        *out = r0 == 0 ? s : *out + s;
      }
      // 2-3. gradient windows, the resident (last) one first
      for (int win = n_windows - 1; win >= 0; --win) {
        if (win != n_windows - 1) {
          __syncthreads();
          stage_quads<kVec, kGradRows>(hs, kLdH, h, r0, b, d, win * window, kqw);
          stage_quads<kVec, kGradTileN>(es, kLdE, ent, n0, n, d, win * window,
                                        kqw);
          cp_async_commit();
          cp_async_wait_all();
          __syncthreads();
        }
        dh_window(dlt, es,
                  part + ((r0 / kGradRows) * n_windows + win) * cg_n * 256,
                  cg_n, t == t_begin);
        if (one_window && t + 1 < t_end) {
          __syncthreads();              // es is read no more: the next tile's
          stage_quads<kVec, kGradTileN>(es, kLdE, ent, n0 + kGradTileN, n, d,
                                        0, kqw);
          cp_async_commit();            // rows arrive under the d_ent product
        }
        dent_window<kVec>(dlt, hs, d_ent, n0, n, d, win * window, cg_n, r0 > 0);
      }
      cp_async_wait_all();
      __syncthreads();                  // dlT, hs and es are free again
    }
  }
}

// d_h = the sum of the n_part partials in block order.  A block takes 32
// consecutive slots of a partial (lanes) and its 8 warps partials w, w + 8,
// ...; the 8 warp sums are added in warp order, and lane l's quad goes to
// its row and columns of d_h.
__global__ void __launch_bounds__(kThreads)
dh_reduce_kernel(const float* __restrict__ partials, float* __restrict__ d_h,
                 int b, int d, int window, int n_windows, int n_part) {
  __shared__ float4 red[kThreads / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t slots = grads_partial_slots(b, window, n_windows);
  const int64_t slot = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (slot < slots) {
    const float4* p = reinterpret_cast<const float4*>(partials) + slot;
#pragma unroll 4
    for (int q = warp; q < n_part; q += kThreads / 32) add4(s, p[q * slots]);
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || slot >= slots) return;
  float4 t = red[0][lane];
#pragma unroll
  for (int k = 1; k < kThreads / 32; ++k) add4(t, red[k][lane]);
  // slot = ((chunk * n_windows + win) * cg_n + cg) * 256 + 32 k + rg
  const int cg_n = window / 8;
  const int rg = static_cast<int>(slot & 31), k = static_cast<int>((slot >> 5) & 7);
  const int64_t unit = slot >> 8;
  const int cg = static_cast<int>(unit % cg_n);
  const int64_t cw = unit / cg_n;
  const int win = static_cast<int>(cw % n_windows);
  const int chunk = static_cast<int>(cw / n_windows);
  const int row = chunk * kGradRows + 4 * rg + (k >> 1);
  const int c = win * window + 8 * cg + 4 * (k & 1);
  if (row >= b) return;
  float* out = d_h + static_cast<int64_t>(row) * d + c;
  const float v[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (c + i < d) out[i] = v[i];
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

// Shared memory of one K2b block at column window `window`.
extern "C" int kgc_fused_bce_grads_smem(int window) {
  return grads_smem_bytes(window);
}

// Launches K2b on `stream`: the pass over entity tiles, then the d_h
// reduction.  d_h, d_ent and d_bias of the dense term are scaled by the
// device scalar *g.  The schedule comes from the caller
// (ops/fused_loss.py:grads_schedule): `blocks` runs of `tiles_per_block`
// 64-entity tiles, none empty; columns in `n_windows` windows of `window`
// (a multiple of 8, at most kMaxWindow); `partials` holds
// blocks * 4 * grads_partial_slots(b, window, n_windows) floats, that is
// blocks * (b rounded up to 128) * window * n_windows.  Returns the cudaError_t of the
// launches (0: success; cudaErrorInvalidValue for a schedule that does not
// fit these rules).  The caller guarantees b, n, d > 0 and owns every
// buffer.
extern "C" int kgc_fused_bce_grads(const void* g, const void* h,
                                   const void* ent, const void* bias,
                                   const void* w, float base, void* d_h,
                                   void* d_ent, void* d_bias, void* partials,
                                   int b, int n, int d, int tiles_per_block,
                                   int blocks, int window, int n_windows,
                                   void* stream) {
  const int n_tiles = (n + kGradTileN - 1) / kGradTileN;
  const int64_t ld_part = static_cast<int64_t>(window) * n_windows;
  if (window <= 0 || window % 8 || window > kMaxWindow || ld_part < d ||
      ld_part - window >= d || tiles_per_block <= 0 || blocks <= 0 ||
      static_cast<int64_t>(blocks) * tiles_per_block < n_tiles ||
      static_cast<int64_t>(blocks - 1) * tiles_per_block >= n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = grads_smem_bytes(window);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {h, ent, d_ent};
  bool aligned = d % 4 == 0;
  for (const void* p : ptrs) aligned &= reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const auto kernel = aligned ? grads_kernel<true> : grads_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(h),
      static_cast<const float*>(ent), static_cast<const float*>(bias),
      static_cast<const float*>(w), base, static_cast<float*>(d_ent),
      static_cast<float*>(d_bias), static_cast<float*>(partials), b, n, d,
      tiles_per_block, window, n_windows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t slots = grads_partial_slots(b, window, n_windows);
  dh_reduce_kernel<<<static_cast<unsigned>((slots + 31) / 32), kThreads, 0, s>>>(
      static_cast<const float*>(partials), static_cast<float*>(d_h), b, d,
      window, n_windows, blocks);
  return static_cast<int>(cudaGetLastError());
}
