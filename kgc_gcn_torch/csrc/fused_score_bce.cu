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
// Both kernels share one schedule and one score product.  Block x owns the
// contiguous run of 64-entity tiles [x * tiles_per_block, ...) and rows in
// chunks of 128; the wrapper sizes the runs so that there are about as many
// blocks as the card has SMs (ops/fused_loss.py: loss_schedule,
// grads_schedule; 128 blocks of 5 tiles at the WN18RR shape, 114 of 2 at
// FB15k-237).  The chunk's h rows and the tile's entity rows arrive by
// 16-byte cp.async (4-byte where d or a base is no multiple of 4 floats),
// zero-filled past B, N and d, so that rows beyond N, which may hold
// anything, are never read.  They are stored as float4 quads of 4 columns,
// quad-major (hs[kq][r], es[kq][e]), and the score tile S (128 x 64) is a
// register-tiled product, 4 rows x 8 entities a thread (score_product):
// K-major LDS.128 reads of both operands, 12 a 128 FMAs, with no bank
// conflict within a quarter-warp.  Columns run in windows when a whole row
// does not fit in shared memory.
//
// K2a: one pass over the block's tiles, S never leaving the SM.
//   * Block (x, y) takes run x and row chunk y: 512 threads, warp
//     specialised.  Warps 0-7 (producers) compute S over the whole depth;
//     warps 8-15 (epilogue) add the terms.  At d <= 200 (kLossMaxWindow; the
//     presets' 200) h's chunk is staged once and the entity tile's two depth
//     halves form the pipeline: each half of the next tile is copied under
//     the product of the other half, one producer barrier a half.  A wider
//     d stages h and the tile window by window, with no overlap.
//   * The producers store S into one of two score buffers (128 x 66 floats)
//     and arrive on its named "full" barrier; the epilogue warps wait on
//     it, read 32 scores a thread (32 rows of one entity), arrive on the
//     buffer's "empty" barrier and add w * (relu(s) - base*s +
//     log1p(exp(-|s|))) in order, 16 at a time (the exps first, then the
//     log1ps, so that the chains interleave), with a select dropping
//     entities past N and rows past B (a zero-filled row scores log 2).
//     So a tile's terms run while the producers compute the next tile.
//   * Deterministic, no atomics: each block writes one partial (the
//     threads' sums added warp by warp, then the 16 warp sums in warp
//     order), and a second launch adds the partials in block order.
//   * 228,160 bytes of shared memory at d 200 and 128 registers a thread:
//     one block an SM.
// What holds it back (tools/k2a_phases.py, PERF.md §6): the product runs
// at the shared-memory rate of the 4 x 8 tile, 21.7k cycles a tile against
// a 19.2k floor (8 x 8 tiles and splits of the depth over warp groups
// were no faster); each softplus term is a ~50-instruction chain, and
// log1pf keeps a branch of its own, so the epilogue warps, beside the
// producers, take longer than the product (30.7k cycles a tile); the
// producers' copies and barriers add 3.4k cycles a tile.
//
// K2b: one pass over entity tiles, each score tile computed once.
//   * Per (row chunk, tile): S becomes the dl tile, kept transposed in
//     shared memory (dlT[e][r]); d_bias and d_ent = dlT h of the tile go
//     straight out (each tile has one owner, so they need no reduction);
//     dlT ent is added into the block's own d_h partial: three products,
//     S computed once.  The gradient products read 4 or 8 columns of a row
//     as LDS.128, a 4 x 8 (d_h) or 8 x 4 (d_ent) register tile a thread.
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
// Rows of h per chunk, entities per tile, slot strides (padded by 4 so that
// the copies' 2 x 4-slot groups of a quarter-warp hit distinct banks)
constexpr int kChunkRows = 128;
constexpr int kTileN = 64;
constexpr int kLdH = kChunkRows + 4;  // float4 slots per quad of hs
constexpr int kLdE = kTileN + 4;      // float4 slots per quad of es
constexpr int kLdL = kChunkRows + 4;  // floats per row of dlT (K2b)
constexpr int kMaxSmem = 232448;      // one block's opt-in maximum (227 KB)
constexpr int kMaxWindow = 248;       // K2b's widest window whose operands fit
// K2a: 8 producer warps (the score product) and 8 epilogue warps (the
// softplus terms); floats per row of a handed-over score tile (66: the 4
// rows a producer warp stores at once fall in distinct banks); the widest
// window beside the two score buffers
constexpr int kProducers = kThreads;
constexpr int kLossThreads = 2 * kThreads;
constexpr int kLdS = kTileN + 2;
constexpr int kLossMaxWindow = 200;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float dl_of(float s, float base, float wg) {
  return (1.f / (1.f + expf(-s)) - base) * wg;
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
// the row-major (n_rows, d) matrix src into quads dst[kq * ld + r], by
// threads 0 .. kThreads - 1.  A warp takes 4 rows x 8 quads at a time (128
// contiguous bytes of each row); quads past n_rows or d are zero-filled
// without a read.  kVec: d and src are multiples of 4 floats, so a quad is
// all in or all out.
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

// The score tile of one thread over the kqw staged quads: acc[i][j] +=
// h row 4rg+i . entity eg+8j (hs[kq][r], es[kq][e]), 12 LDS.128 a quad for
// 128 FMAs.  A quarter-warp's 8 lanes share rg: its h reads are one
// broadcast slot, its entity reads 8 consecutive slots.
__device__ __forceinline__ void score_product(const float4* hs,
                                              const float4* es, int kqw,
                                              int rg, int eg,
                                              float (&acc)[4][8]) {
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
}

// Named barrier `id` of `count` threads: wait for it, or only arrive.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------- K2a

// K2a's named barriers: the producers among themselves; score buffer k
// full (producers arrive, epilogue warps wait) and empty (the other way);
// the epilogue warps among themselves.
constexpr int kBarProducers = 1, kBarFull = 2, kBarEmpty = 4, kBarEpilogue = 6;

// h's chunk, one entity tile, two score buffers, the chunk's row weights
// and the 16 warp sums, at column window `window`
__host__ __device__ constexpr int loss_smem_bytes(int window) {
  return 16 * (window / 4) * (kLdH + kLdE) + 4 * 2 * kChunkRows * kLdS +
         4 * kChunkRows + 4 * (kLossThreads / 32);
}
static_assert(loss_smem_bytes(kLossMaxWindow) <= kMaxSmem &&
                  loss_smem_bytes(kLossMaxWindow + 8) > kMaxSmem,
              "kLossMaxWindow is the widest window of 8 columns that fits");

// sum + w * (relu(s) - base*s + log1p(exp(-|s|))), s = x[m] + bj, over 16
// scores of one entity, in order; a select drops rows past B (bit m of
// row_ok) and entities past N (ok).  The 16 exps come first, then the 16
// log1ps, so that their chains interleave.
__device__ __forceinline__ float add_terms(float sum, const float (&x)[16],
                                          const float* wr, float bj, bool ok,
                                          unsigned row_ok, float base) {
  float s[16], e[16];
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    s[m] = x[m] + bj;
    e[m] = expf(-fabsf(s[m]));
  }
#pragma unroll
  for (int m = 0; m < 16; ++m) e[m] = log1pf(e[m]);
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const float t = wr[m] * (fmaxf(s[m], 0.f) - base * s[m] + e[m]);
    sum += ok && (row_ok >> m & 1) ? t : 0.f;
  }
  return sum;
}

// The pass over entity tiles (see the note at the top): block (x, y) adds
// the terms of its tiles and of row chunk y into partials[y * gridDim.x +
// x].  Warps 0-7 (the producers) compute each tile's scores, 4 rows x 8
// entities a thread, over the whole depth, and store them in score buffer
// u & 1 (the block's u-th tile); warps 8-15 add their terms, 32 rows of one
// entity a thread, while the producers compute the next tile.
template <bool kVec>
__global__ void __launch_bounds__(kLossThreads, 1)
loss_tiles_kernel(const float* __restrict__ h, const float* __restrict__ ent,
                  const float* __restrict__ bias, const float* __restrict__ w,
                  float base, float* __restrict__ partials, int b, int n,
                  int d, int tiles_per_block, int window, int n_windows) {
  extern __shared__ float4 smem4[];
  const int kqw = window / 4;
  float4* hs = smem4;                            // [kqw][kLdH]
  float4* es = hs + kqw * kLdH;                  // [kqw][kLdE]
  float* sb = reinterpret_cast<float*>(es + kqw * kLdE);  // [2][128][kLdS]
  float* wsm = sb + 2 * kChunkRows * kLdS;       // [128]
  float* red = wsm + kChunkRows;                 // [16]
  const int n_tiles = (n + kTileN - 1) / kTileN;
  const int first = blockIdx.x * tiles_per_block;
  const int run = min(tiles_per_block, n_tiles - first);
  const int r0 = blockIdx.y * kChunkRows;
  float sum = 0.f;

  if (threadIdx.x < kProducers) {
    const int eg = threadIdx.x & 7, rg = threadIdx.x >> 3;  // rows 4rg+i,
    const int hq = (kqw + 1) / 2;                         // entities eg+8j
    if (n_windows == 1) {
      // h's chunk once; the tile's depth halves double as a pipeline: half
      // 0 of the next tile is copied under half 1's product and half 1
      // under the next tile's half 0, each half's barrier both freeing it
      // and showing the other half's copies
      stage_quads<kVec, kChunkRows>(hs, kLdH, h, r0, b, d, 0, kqw);
      stage_quads<kVec, kTileN>(es, kLdE, ent, first * kTileN, n, d, 0, kqw);
      cp_async_commit();
      cp_async_wait_all();
      named_sync(kBarProducers, kProducers);
    }
    for (int u = 0; u < run; ++u) {
      const int n0 = (first + u) * kTileN;
      const bool more = u + 1 < run;
      float acc[4][8] = {};
      if (n_windows == 1) {
        score_product(hs, es, hq, rg, eg, acc);
        cp_async_wait_all();                    // this tile's half 1
        named_sync(kBarProducers, kProducers);  // and half 0 is read
        if (more)
          stage_quads<kVec, kTileN>(es, kLdE, ent, n0 + kTileN, n, d, 0, hq);
        cp_async_commit();
        score_product(hs + hq * kLdH, es + hq * kLdE, kqw - hq, rg, eg, acc);
        cp_async_wait_all();                    // the next tile's half 0
        named_sync(kBarProducers, kProducers);  // and half 1 is read
        if (more)
          stage_quads<kVec, kTileN>(es + hq * kLdE, kLdE, ent, n0 + kTileN, n,
                                    d, 4 * hq, kqw - hq);
        cp_async_commit();
      } else {
        for (int win = 0; win < n_windows; ++win) {
          named_sync(kBarProducers, kProducers);  // the last window is read
          stage_quads<kVec, kChunkRows>(hs, kLdH, h, r0, b, d, win * window,
                                        kqw);
          stage_quads<kVec, kTileN>(es, kLdE, ent, n0, n, d, win * window,
                                    kqw);
          cp_async_commit();
          cp_async_wait_all();
          named_sync(kBarProducers, kProducers);
          score_product(hs, es, kqw, rg, eg, acc);
        }
      }
      // hand the tile over: buffer u & 1, once its last reader is done
      float* out = sb + (u & 1) * kChunkRows * kLdS;
      if (u >= 2) named_sync(kBarEmpty + (u & 1), kLossThreads);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          out[(4 * rg + i) * kLdS + eg + 8 * j] = acc[i][j];
      named_arrive(kBarFull + (u & 1), kLossThreads);
    }
  } else {
    // epilogue warps: entity q & 63 of each tile, rows 32 (q >> 6) + m
    const int q = threadIdx.x - kProducers;
    const int e = q & 63, m0 = 32 * (q >> 6);
    if (q < kChunkRows) wsm[q] = r0 + q < b ? __ldg(w + r0 + q) : 0.f;
    unsigned row_ok[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int rows = b - (r0 + m0 + 16 * c);  // rows left from there
      row_ok[c] = rows >= 16 ? 0xffffu : rows > 0 ? (1u << rows) - 1 : 0u;
    }
    named_sync(kBarEpilogue, kLossThreads - kProducers);  // wsm is written
    for (int u = 0; u < run; ++u) {
      const int col = (first + u) * kTileN + e;
      const bool ok = col < n;
      const float bj = ok ? __ldg(bias + col) : 0.f;
      named_sync(kBarFull + (u & 1), kLossThreads);
      const float* in = sb + (u & 1) * kChunkRows * kLdS + m0 * kLdS + e;
      float x[2][16];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int m = 0; m < 16; ++m) x[c][m] = in[(16 * c + m) * kLdS];
      if (u + 2 < run) named_arrive(kBarEmpty + (u & 1), kLossThreads);
#pragma unroll
      for (int c = 0; c < 2; ++c)
        sum = add_terms(sum, x[c], wsm + m0 + 16 * c, bj, ok, row_ok[c], base);
    }
  }
  sum = warp_sum(sum);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = red[0];
#pragma unroll
    for (int k = 1; k < kLossThreads / 32; ++k) t += red[k];
    partials[blockIdx.y * gridDim.x + blockIdx.x] = t;
  }
}

// *out = the n_part partials added in block order by thread 0, from
// shared memory: the block loads kThreads partials at a time.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partials, int n_part,
                    float* __restrict__ out) {
  __shared__ float part[kThreads];
  float t = 0.f;
  for (int p0 = 0; p0 < n_part; p0 += kThreads) {
    const int m = min(kThreads, n_part - p0);
    if (threadIdx.x < m) part[threadIdx.x] = partials[p0 + threadIdx.x];
    __syncthreads();
    if (threadIdx.x == 0)
      for (int i = 0; i < m; ++i) t += part[i];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = t;
}

// ---------------------------------------------------------------- K2b

__host__ __device__ inline int grads_smem_bytes(int window) {
  return 16 * (window / 4) * (kLdH + kLdE) + 4 * kTileN * kLdL;
}

// float4 slots of one block's d_h partial: 256 a (row chunk, window, column
// group of 8), rows padded to whole chunks of 128.
__host__ __device__ inline int64_t grads_partial_slots(int b, int window,
                                                       int n_windows) {
  return static_cast<int64_t>((b + kChunkRows - 1) / kChunkRows) * n_windows *
         (window / 8) * 256;
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
    for (int e = 0; e < kTileN; ++e) {
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
    for (int rq = 0; rq < kChunkRows / 4; ++rq) {
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
  float* dlt = reinterpret_cast<float*>(es + kqw * kLdE); // [kTileN][kLdL]
  const int n_tiles = (n + kTileN - 1) / kTileN;
  const int t_begin = blockIdx.x * tiles_per_block;
  const int t_end = min(t_begin + tiles_per_block, n_tiles);
  float4* part = reinterpret_cast<float4*>(partials) +
                 blockIdx.x * grads_partial_slots(b, window, n_windows);
  const float gs = *g;
  const bool one_window = n_windows == 1;
  const int eg = threadIdx.x & 7, rg = threadIdx.x >> 3;  // score tile owner

  for (int r0 = 0; r0 < b; r0 += kChunkRows) {
    if (one_window) {
      stage_quads<kVec, kChunkRows>(hs, kLdH, h, r0, b, d, 0, kqw);
      stage_quads<kVec, kTileN>(es, kLdE, ent, t_begin * kTileN, n, d,
                                    0, kqw);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }
    for (int t = t_begin; t < t_end; ++t) {
      const int n0 = t * kTileN;
      // 1. S: rows 4rg..4rg+3 x entities eg + 8j, K-major quads
      float acc[4][8] = {};
      for (int win = 0; win < n_windows; ++win) {
        if (!one_window) {
          stage_quads<kVec, kChunkRows>(hs, kLdH, h, r0, b, d, win * window, kqw);
          stage_quads<kVec, kTileN>(es, kLdE, ent, n0, n, d, win * window,
                                        kqw);
          cp_async_commit();
          cp_async_wait_all();
          __syncthreads();
        }
        score_product(hs, es, kqw, rg, eg, acc);
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
      if (threadIdx.x < kTileN && n0 + threadIdx.x < n) {
        const float4* row = reinterpret_cast<const float4*>(dlt + threadIdx.x * kLdL);
        float s = 0.f;
        for (int q = 0; q < kChunkRows / 4; ++q) {
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
          stage_quads<kVec, kChunkRows>(hs, kLdH, h, r0, b, d, win * window, kqw);
          stage_quads<kVec, kTileN>(es, kLdE, ent, n0, n, d, win * window,
                                        kqw);
          cp_async_commit();
          cp_async_wait_all();
          __syncthreads();
        }
        dh_window(dlt, es,
                  part + ((r0 / kChunkRows) * n_windows + win) * cg_n * 256,
                  cg_n, t == t_begin);
        if (one_window && t + 1 < t_end) {
          __syncthreads();              // es is read no more: the next tile's
          stage_quads<kVec, kTileN>(es, kLdE, ent, n0 + kTileN, n, d,
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
  const int row = chunk * kChunkRows + 4 * rg + (k >> 1);
  const int c = win * window + 8 * cg + 4 * (k & 1);
  if (row >= b) return;
  float* out = d_h + static_cast<int64_t>(row) * d + c;
  const float v[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (c + i < d) out[i] = v[i];
}

}  // namespace

// Shared memory of one K2a block at column window `window`.
extern "C" int kgc_fused_bce_loss_smem(int window) {
  return loss_smem_bytes(window);
}

// Partials K2a writes for `b` rows and `n` entities in runs of
// `tiles_per_block` tiles: one a block, a block a (run, row chunk).
extern "C" int kgc_fused_bce_loss_partials(int b, int n, int tiles_per_block) {
  const int n_tiles = (n + kTileN - 1) / kTileN;
  return (n_tiles + tiles_per_block - 1) / tiles_per_block *
         ((b + kChunkRows - 1) / kChunkRows);
}

// Launches K2a on `stream`: the pass over entity tiles, then the sum of the
// partials; *out receives the dense term.  The schedule comes from the
// caller (ops/fused_loss.py:loss_schedule): `blocks` runs of
// `tiles_per_block` 64-entity tiles, none empty, each with every chunk of
// 128 rows; columns in `n_windows` windows of `window` (a multiple of 8, at
// most kLossMaxWindow); `partials` holds kgc_fused_bce_loss_partials
// floats.  Returns the cudaError_t of the
// launches (0: success; cudaErrorInvalidValue for a schedule that does not
// fit these rules).  The caller guarantees b, n, d > 0 and owns every
// buffer.
extern "C" int kgc_fused_bce_loss(const void* h, const void* ent,
                                  const void* bias, const void* w, float base,
                                  void* partials, void* out, int b, int n,
                                  int d, int tiles_per_block, int blocks,
                                  int window, int n_windows, void* stream) {
  const int n_tiles = (n + kTileN - 1) / kTileN;
  const int64_t cols = static_cast<int64_t>(window) * n_windows;
  if (window <= 0 || window % 8 || window > kLossMaxWindow || n_windows < 1 ||
      cols < d || cols - window >= d || tiles_per_block <= 0 ||
      blocks <= 0 || static_cast<int64_t>(blocks) * tiles_per_block < n_tiles ||
      static_cast<int64_t>(blocks - 1) * tiles_per_block >= n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = loss_smem_bytes(window);
  const void* ptrs[] = {h, ent};
  bool aligned = d % 4 == 0;
  for (const void* p : ptrs) aligned &= reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const auto kernel = aligned ? loss_tiles_kernel<true> : loss_tiles_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (b + kChunkRows - 1) / kChunkRows;
  kernel<<<dim3(blocks, chunks), kLossThreads, smem, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(ent),
      static_cast<const float*>(bias), static_cast<const float*>(w), base,
      static_cast<float*>(partials), b, n, d, tiles_per_block, window,
      n_windows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<1, kThreads, 0, s>>>(
      static_cast<const float*>(partials), blocks * chunks,
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
  const int n_tiles = (n + kTileN - 1) / kTileN;
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
