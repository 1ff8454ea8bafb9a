// The optimizer layer's fused step: global-norm clipping, weight decay and
// Adam over every leaf of the parameter list in two launches, whatever the
// number of leaves.
//
//   norm = sqrt(sum over every leaf of g * g)                  (pass A)
//   g    = g if norm < max_norm else (g / norm) * max_norm     (max_norm > 0)
//   g    = g + wd * p                                          (wd > 0)
//   m    = (1 - b1) * g + b1 * mu
//   v    = (1 - b2) * (g * g) + b2 * nu
//   p    = p + -lr * ((m / bc1) / (sqrt(v / bc2) + eps))       (pass B)
//
// with mu, nu := m, v stored in the moments' dtype (float32, or bfloat16
// rounded to nearest even).  This is train/optim.py:step: optax's
// clip_by_global_norm, add_decayed_weights and scale_by_adam with the
// epoch's lr, as the JAX package chains them.  It replaces no TPU kernel:
// the JAX package leaves that chain to XLA, which fuses it.  The plain step
// launches ~22 elementwise kernels a leaf, each a full pass over the leaf.
//
// Bound: memory.  The least a step moves is g read once for the norm, then
// p, g, m and v read and p, m and v written once: 8 passes over the state
// (bfloat16 moments move half their bytes).  MGCN + ConvE at YAGO3-10's
// counts holds 236 M float32 elements in 21 leaves: 7.56 GB, 2.26 ms at
// 3.35 TB/s.  A dozen float operations an element are far below the card's
// balance of operations per byte.  The design moves each byte once:
//   * leaves by value: the host packs the leaves' addresses, sizes and tile
//     offsets into a struct passed as the launch's argument
//     (__grid_constant__, read from the constant bank), so no table is
//     copied to the device and the gradients' new addresses each step cost
//     nothing; a list of more than kMaxLeaves leaves takes a launch of each
//     pass per kMaxLeaves;
//   * tiles: each leaf is cut into tiles of 256 threads x 4 elements x an
//     unroll; a tile lies in one leaf, so a block finds its leaf once a
//     tile.  16-byte loads and stores (8-byte for four bfloat16 moments)
//     where all of a leaf's pointers allow, scalars for the 1-3 elements
//     past its last whole group of 4, and scalar lanes over a leaf whose
//     pointers do not (a gradient cut from a flat all-reduce buffer).
//     Offsets are 64-bit;
//   * pass A (adam_norm): a fixed grid of at most kNormBlocks blocks walks
//     the tiles in a fixed order, each thread summing squares in double;
//     each block's sums are reduced in a fixed order into its slot of
//     `partials`, and the last block to arrive (atomicAdd on a counter that
//     it sets back to 0) adds the slots in a fixed order.  So the norm is
//     the same bits on every run, and stays on the device.  Two sums: the
//     leaves marked sharded (one rank's slice of a leaf split over a graph
//     axis, which the caller sums over the group between the passes) and
//     the rest;
//   * pass B (adam_update): one tile a block.  Each thread forms the norm
//     from the two sums itself, loads its whole tile before computing, and
//     stores each element once.
// Every operation is rounded once, as the plain step rounds it: __fmul_rn,
// __fadd_rn, __fdiv_rn and __fsqrt_rn, never contracted into an FMA, with
// IEEE division and square root.  The plain step on the card sums the
// squares in float32 in another order and divides by bc1 and bc2 as a
// multiply by a float reciprocal, so the two agree within a few ulp, not to
// the bit.

#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLeaves = 64;
constexpr int kNormBlocks = 1024;
// groups of 4 elements a thread takes in a tile: pass A loads only g, so it
// takes more of them to keep as many bytes in flight
constexpr int kNormUnroll = 4;
constexpr int kUpdateUnroll = 2;
constexpr int64_t kNormTile = int64_t{kThreads} * 4 * kNormUnroll;
constexpr int64_t kUpdateTile = int64_t{kThreads} * 4 * kUpdateUnroll;
constexpr uint8_t kSharded = 1;
constexpr uint8_t kVectors = 2;

struct Leaves {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  void* m[kMaxLeaves];
  void* v[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int64_t tile_end[kMaxLeaves];   // the tiles of leaves 0..i
  uint8_t flags[kMaxLeaves];      // kSharded | kVectors
  int count;
};

struct Scalars {
  float max_norm;   // > 0: clip by the global norm
  float wd;         // > 0: g + wd * p
  float b1, b2, one_minus_b1, one_minus_b2, bc1, bc2, eps, neg_lr;
};

struct alignas(8) Bf16x4 {
  __nv_bfloat162 lo, hi;
};

__device__ __forceinline__ int64_t tile_start(const Leaves& t, int leaf) {
  return leaf ? t.tile_end[leaf - 1] : 0;
}

// The leaf that holds `tile`: the first whose tile_end exceeds it (a leaf
// of no elements has no tiles and is never found).
__device__ __forceinline__ int leaf_of(const Leaves& t, int64_t tile) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tile < t.tile_end[mid]) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

__device__ __forceinline__ float4 load4(const float* p, int64_t i) {
  return *reinterpret_cast<const float4*>(p + i);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int64_t i) {
  const Bf16x4 raw = *reinterpret_cast<const Bf16x4*>(p + i);
  const float2 lo = __bfloat1622float2(raw.lo), hi = __bfloat1622float2(raw.hi);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, int64_t i, float4 x) {
  *reinterpret_cast<float4*>(p + i) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, int64_t i, float4 x) {
  Bf16x4 out;
  out.lo = __floats2bfloat162_rn(x.x, x.y);   // .x at the lower address
  out.hi = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<Bf16x4*>(p + i) = out;
}
__device__ __forceinline__ float load1(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store1(float* p, int64_t i, float x) { p[i] = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, int64_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// ------------------------------------------------------------------ pass A

__device__ __forceinline__ double square(float x) {
  const double d = x;
  return d * d;
}

// This thread's share of the squares of one tile of g, in a fixed order.
__device__ __forceinline__ double tile_squares(const float* __restrict__ g,
                                               int64_t n, int64_t base,
                                               bool vectors) {
  double s = 0.0;
  if (vectors) {
    float4 x[kNormUnroll];
#pragma unroll
    for (int j = 0; j < kNormUnroll; ++j) {
      const int64_t i = base + 4 * (int64_t{j} * kThreads + threadIdx.x);
      x[j] = i + 3 < n ? load4(g, i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kNormUnroll; ++j) {
      const int64_t i = base + 4 * (int64_t{j} * kThreads + threadIdx.x);
      if (i + 3 < n) {
        s += square(x[j].x) + square(x[j].y) + square(x[j].z) + square(x[j].w);
      } else {
        for (int64_t k = i; k < n; ++k) s += square(g[k]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4 * kNormUnroll; ++j) {
      const int64_t i = base + int64_t{j} * kThreads + threadIdx.x;
      if (i < n) s += square(g[i]);
    }
  }
  return s;
}

// The block's sum of x, in thread 0 (the others get 0), in a fixed order.
__device__ double block_sum(double x, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) x += red[w];
  }
  __syncthreads();
  return x;
}

// sums[0] (+)= the squares of the unsharded leaves, sums[1] (+)= those of
// the sharded ones; `partials` holds 2 * gridDim.x doubles, `arrivals` one
// counter that is 0 on entry and is left 0.
__global__ void __launch_bounds__(kThreads)
adam_norm(const __grid_constant__ Leaves t, double* __restrict__ partials,
          unsigned int* __restrict__ arrivals, double* __restrict__ sums,
          int accumulate) {
  __shared__ double red[kWarps];
  __shared__ bool last;
  const int64_t tiles = t.tile_end[t.count - 1];
  double own = 0.0, shard = 0.0;
  int leaf = 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    while (tile >= t.tile_end[leaf]) ++leaf;
    const double s = tile_squares(t.g[leaf], t.n[leaf],
                                  (tile - tile_start(t, leaf)) * kNormTile,
                                  t.flags[leaf] & kVectors);
    if (t.flags[leaf] & kSharded) {
      shard += s;
    } else {
      own += s;
    }
  }
  own = block_sum(own, red);
  shard = block_sum(shard, red);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = own;
    partials[2 * blockIdx.x + 1] = shard;
    __threadfence();
    last = atomicAdd(arrivals, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  own = shard = 0.0;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) {
    own += __ldcg(partials + 2 * b);
    shard += __ldcg(partials + 2 * b + 1);
  }
  own = block_sum(own, red);
  shard = block_sum(shard, red);
  if (threadIdx.x == 0) {
    sums[0] = accumulate ? sums[0] + own : own;
    sums[1] = accumulate ? sums[1] + shard : shard;
    *arrivals = 0u;
  }
}

// ------------------------------------------------------------------ pass B

__device__ __forceinline__ void adam(float& p, float g, float& m, float& v,
                                     const Scalars& s, float norm) {
  if (s.max_norm > 0.f && !(norm < s.max_norm)) {
    g = __fmul_rn(__fdiv_rn(g, norm), s.max_norm);
  }
  if (s.wd > 0.f) g = __fadd_rn(g, __fmul_rn(s.wd, p));
  m = __fadd_rn(__fmul_rn(s.one_minus_b1, g), __fmul_rn(s.b1, m));
  v = __fadd_rn(__fmul_rn(s.one_minus_b2, __fmul_rn(g, g)), __fmul_rn(s.b2, v));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps);
  p = __fadd_rn(p, __fmul_rn(s.neg_lr, __fdiv_rn(__fdiv_rn(m, s.bc1), den)));
}

template <typename M>
__device__ __forceinline__ void adam_at(float* __restrict__ p,
                                        const float* __restrict__ g,
                                        M* __restrict__ m, M* __restrict__ v,
                                        int64_t i, const Scalars& s,
                                        float norm) {
  float pi = p[i], mi = load1(m, i), vi = load1(v, i);
  adam(pi, g[i], mi, vi, s, norm);
  p[i] = pi;
  store1(m, i, mi);
  store1(v, i, vi);
}

// own, shard: the two sums of pass A (shard summed over the graph group);
// unread when s.max_norm is 0.
template <typename M>
__global__ void __launch_bounds__(kThreads)
adam_update(const __grid_constant__ Leaves t, const double* __restrict__ own,
            const double* __restrict__ shard, const Scalars s) {
  const int64_t tile = blockIdx.x;
  const int leaf = leaf_of(t, tile);
  const int64_t n = t.n[leaf];
  const int64_t base = (tile - tile_start(t, leaf)) * kUpdateTile;
  float* __restrict__ p = t.p[leaf];
  const float* __restrict__ g = t.g[leaf];
  M* __restrict__ m = static_cast<M*>(t.m[leaf]);
  M* __restrict__ v = static_cast<M*>(t.v[leaf]);
  const float norm =
      s.max_norm > 0.f ? __fsqrt_rn(static_cast<float>(*own + *shard)) : 0.f;
  if (t.flags[leaf] & kVectors) {
    float4 pv[kUpdateUnroll], gv[kUpdateUnroll], mv[kUpdateUnroll],
        vv[kUpdateUnroll];
#pragma unroll
    for (int j = 0; j < kUpdateUnroll; ++j) {
      const int64_t i = base + 4 * (int64_t{j} * kThreads + threadIdx.x);
      if (i + 3 < n) {
        pv[j] = load4(p, i);
        gv[j] = load4(g, i);
        mv[j] = load4(m, i);
        vv[j] = load4(v, i);
      }
    }
#pragma unroll
    for (int j = 0; j < kUpdateUnroll; ++j) {
      const int64_t i = base + 4 * (int64_t{j} * kThreads + threadIdx.x);
      if (i + 3 < n) {
        adam(pv[j].x, gv[j].x, mv[j].x, vv[j].x, s, norm);
        adam(pv[j].y, gv[j].y, mv[j].y, vv[j].y, s, norm);
        adam(pv[j].z, gv[j].z, mv[j].z, vv[j].z, s, norm);
        adam(pv[j].w, gv[j].w, mv[j].w, vv[j].w, s, norm);
        store4(p, i, pv[j]);
        store4(m, i, mv[j]);
        store4(v, i, vv[j]);
      } else {
        for (int64_t k = i; k < n; ++k) adam_at(p, g, m, v, k, s, norm);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4 * kUpdateUnroll; ++j) {
      const int64_t i = base + int64_t{j} * kThreads + threadIdx.x;
      if (i < n) adam_at(p, g, m, v, i, s, norm);
    }
  }
}

// ------------------------------------------------------------------- host

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Leaves [lo, lo + count) in tiles of `tile` elements.  p, m and v are null
// for pass A, which reads g alone; a leaf takes vectors where every pointer
// it reads is aligned (m and v to `m_align` bytes).
Leaves pack(void* const* p, const void* const* g, void* const* m,
            void* const* v, const int64_t* n, const uint8_t* sharded, int lo,
            int count, int64_t tile, uintptr_t m_align) {
  Leaves t{};
  int64_t tiles = 0;
  for (int i = 0; i < count; ++i) {
    const int k = lo + i;
    bool vectors = aligned(g[k], 16);
    t.g[i] = static_cast<const float*>(g[k]);
    if (p != nullptr) {
      t.p[i] = static_cast<float*>(p[k]);
      t.m[i] = m[k];
      t.v[i] = v[k];
      vectors = vectors && aligned(p[k], 16) && aligned(m[k], m_align) &&
                aligned(v[k], m_align);
    }
    t.n[i] = n[k];
    tiles += (n[k] + tile - 1) / tile;
    t.tile_end[i] = tiles;
    t.flags[i] = static_cast<uint8_t>(
        (sharded != nullptr && sharded[k] ? kSharded : 0) |
        (vectors ? kVectors : 0));
  }
  t.count = count;
  return t;
}

}  // namespace

extern "C" int kgc_fused_adam_norm_blocks() { return kNormBlocks; }

// Pass A on `stream` over the gradients g[0..count) of n[i] float32
// elements each: sums (2 doubles) = the squares of the leaves whose
// sharded[i] is 0, and of those whose sharded[i] is 1.  partials holds
// 2 * kgc_fused_adam_norm_blocks() doubles; arrivals one uint32 that is 0
// and is left 0.  count >= 1.  Returns the cudaError_t of the launches.
extern "C" int kgc_fused_adam_norm(const void* const* g, const int64_t* n,
                                   const uint8_t* sharded, int count,
                                   void* partials, void* arrivals, void* sums,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int lo = 0; lo < count; lo += kMaxLeaves) {
    const int c = std::min(kMaxLeaves, count - lo);
    const Leaves t = pack(nullptr, g, nullptr, nullptr, n, sharded, lo, c,
                          kNormTile, 16);
    const int64_t tiles = t.tile_end[c - 1];
    const int grid = static_cast<int>(
        std::max<int64_t>(1, std::min<int64_t>(tiles, kNormBlocks)));
    adam_norm<<<grid, kThreads, 0, s>>>(
        t, static_cast<double*>(partials), static_cast<unsigned int*>(arrivals),
        static_cast<double*>(sums), lo > 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Pass B on `stream`: the clip (max_norm > 0; own and shard point at pass
// A's two sums, the sharded one already summed over the graph group), the
// weight decay (wd > 0) and the Adam update of the leaves p, g, m, v of n[i]
// elements each, in place.  p and g are float32, m and v bfloat16 when
// bf16_moments, else float32.  Returns the cudaError_t of the launches.
extern "C" int kgc_fused_adam_update(
    void* const* p, const void* const* g, void* const* m, void* const* v,
    const int64_t* n, int count, int bf16_moments, const void* own,
    const void* shard, float max_norm, float wd, float b1, float b2,
    float one_minus_b1, float one_minus_b2, float bc1, float bc2, float eps,
    float neg_lr, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scalars sc{max_norm, wd, b1, b2, one_minus_b1, one_minus_b2,
                   bc1, bc2, eps, neg_lr};
  const double* a = static_cast<const double*>(own);
  const double* b = static_cast<const double*>(shard);
  for (int lo = 0; lo < count; lo += kMaxLeaves) {
    const int c = std::min(kMaxLeaves, count - lo);
    const Leaves t = pack(p, g, m, v, n, nullptr, lo, c, kUpdateTile,
                          bf16_moments ? 8 : 16);
    const int64_t tiles = t.tile_end[c - 1];
    if (tiles == 0) continue;
    if (tiles >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
    if (bf16_moments) {
      adam_update<__nv_bfloat16><<<static_cast<unsigned int>(tiles), kThreads,
                                   0, s>>>(t, a, b, sc);
    } else {
      adam_update<float><<<static_cast<unsigned int>(tiles), kThreads, 0, s>>>(
          t, a, b, sc);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
