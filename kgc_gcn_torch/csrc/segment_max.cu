// Kernel K5 of the port: sorted CSR segment-max.
//
//   out[r, h] = max over indptr[r] <= e < indptr[r+1] of logits[e, h]
//
// logits is (E, H) float32, dst (E,) int32 the non-decreasing row of each
// edge, indptr (n_rows+1,) int32 its CSR pointers, out (n_rows, H) float32;
// rows with no edges get -inf (the identity of max, as jax.ops.segment_max
// gives).  Edges outside [indptr[0], indptr[n_rows]) belong to no row.
// Replaces the TPU kernel kgc_gcn_tpu/ops/spmm_pallas.py:_seg_max_kernel
// (called through segment_max_sorted), which masks a (tile_n, tile_e)
// dst-match matrix and reduces each head across lanes because a max has no
// one-hot matmul form.  None of that carries over to the card.
//
// Bound: memory.  Each logit, indptr entry and output element moved once,
// 4*E*H + 4*(n_rows+1) + 4*n_rows*H bytes, against one comparison per logit.
// At the RGAT path's shape (E 87,040, H 4, 40,943 rows) that is 0.66 us, far
// below one launch.
//
// Design: lanes over edges, one wave, hub rows cut over the grid.  The
// time of such a call is set by its slowest warp's chain of dependent
// memory rounds and instructions, so the design counts both.
//   * chunks: warp k takes the C = 128 edge positions [k*C, (k+1)*C), lane
//     i the 4 consecutive ones from k*C + 4*i (dst as one int4, the logits
//     as float4 a position); the grid has E / C + 1 warps, so position E
//     (the end sentinel) has a warp too.  Every address of the first round
//     of loads comes from the shape: the chunk's dst and logits, indptr's
//     two ends, dst just before the chunk and at k*C + C - L - 1, the dst
//     and logits of the first window of 32 positions after the chunk, and
//     the last dst of each of the (L - C) / 32 = 12 windows there;
//   * keys: an edge's key is its row; a position before indptr[0] is -1,
//     one from indptr[n_rows] on is n_rows.  A lane reduces its runs of
//     equal keys in registers; one segmented inclusive scan by
//     __shfl_up_sync of each lane's last run, keyed on its row, then one
//     carry into each lane's first run, close every row (5 + 1 shuffles a
//     head a warp); a row's last position (the next key differs) holds its
//     max;
//   * owner and limit: a row belongs to the chunk that holds its first
//     edge, which writes it.  A row that runs past its chunk's end is read
//     on by its owner, lanes over the edges, if it has at most L = 512
//     edges; later chunks skip it.  The window whose last key is another
//     row holds the row's end, so a row that started in the chunk and ends
//     in a window needs no indptr: one that ends in the first window (most
//     rows of a few dozen edges) takes the logits the first round loaded,
//     and for a longer one the owner loads the windows up to its end at
//     once (8 windows a batch; the last one whole, masked by its keys, so
//     that its loads go with the others).  A first row that ends in the
//     chunk and does not hold position k*C + C - L - 1 is short too.  Only
//     a row longer than these probes show reads its indptr pointers, in a
//     second round;
//   * pieces: a row of more than L edges (a hub) is cut at the chunk
//     boundaries.  Every chunk that holds a piece writes the piece's max to
//     partials[k][slot] (slot 0: the row holds the chunk's first edge;
//     slot 1: the chunk's last row, starting later); the lane that wrote it
//     then arrives on the row's counter (__threadfence, atomicAdd).  The
//     last piece to arrive combines the row's partials (lanes over the
//     pieces, then the warp's max), writes the row and sets its counter
//     back to 0.  No warp walks more than L edges of a row or waits on
//     another;
//   * empty rows: the lane of each position in [indptr[0], indptr[n_rows]]
//     writes -inf to the rows strictly between the key before it and its
//     own (-1 before the first edge, n_rows at the sentinel): the rows
//     before the first edge, the gaps, the rows after the last edge, and
//     every row when there is no edge.  More than 16 elements of a lane's
//     gaps are written by the whole warp;
//   * heads: where H is a multiple of 4 and logits and dst are 16-byte
//     aligned, a lane reads an edge's heads as float4.  Heads beyond one
//     register chunk (kChunk 4 or 16) run chunk by chunk over the same
//     keys.
// Bytes: each logit is read once, except the first window after each chunk
// (its first register chunk of heads; the next chunk reads it too, mostly
// from L2), the later windows that an owner reads on and, for a row that
// ends past the first window, up to 31 logits after its end; dst once plus
// the probes (about (L - C) / 32 + 35 a chunk); the partials (2*H floats a
// chunk, hubs only).  Nothing syncs the host: the schedule
// (ops/segment_max.py:segment_max_schedule) comes from the shapes alone.
//
// Scratch: partials, (E/C + 1, 2, H) float32, uninitialised; arrivals,
// int32 per row, zero on entry and left zero on exit (each combiner resets
// its row).  Two launches that run at once must not share the arrivals, so
// the wrapper keeps one buffer per device and stream.
//
// Determinism and rules: every max is taken in an order fixed by the
// shapes (a lane's positions in edge order, the scan's fixed tree, the
// read-on and the pieces through a warp reduction), so two calls give the
// same bits.  A max is exact: the value equals any other order's.  NaN: a
// NaN logit wins its row and head (max.NaN.f32; the result is the
// canonical NaN, as torch's "amax" and jnp.maximum give a NaN; plain fmaxf
// would drop it).  +-0: a row holding both -0.0 and +0.0 may give either;
// which one is fixed by the shapes, so it is the same on every call.
//
// The kernel asserts on the device that indptr's ends lie inside [0, E],
// that dst lies in [0, n_rows) and rises, and that a cut row's pointers lie
// inside [indptr[0], indptr[n_rows]], so a bad input faults instead of
// reading or writing out of bounds, without a host sync on every launch.

#include <cassert>
#include <climits>
#include <cstdint>
#include <math_constants.h>

#include <cuda_runtime.h>

namespace {

constexpr int kPer = 4;                // consecutive positions a lane takes
constexpr int kC = 32 * kPer;          // positions a warp takes: the chunk
constexpr int kL = 512;                // the longest row an owner reads on
constexpr int kWin = (kL - kC) / 32;   // windows of 32 probed past a chunk
static_assert((kL - kC) % 32 == 0 && 0 < kWin && kWin <= 32,
              "the probes are one dst load a lane");
constexpr int kWarps = 4;         // warps per block
constexpr int kLaneGap = 16;      // most -inf elements a lane writes alone
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* logits;
  const int* dst;
  const int* indptr;
  float* out;
  float* partials;
  int* arrivals;
  int n_rows, n_edges, h;
};

// max that keeps a NaN of either operand (the canonical NaN): one FMNMX
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// An int whose signed order is the float's (-0.0 below +0.0), NaN above
// +inf, and back: a warp's max in one REDUX.
__device__ __forceinline__ int order_key(float x) {
  const int i = __float_as_int(x);
  return x != x ? INT_MAX : i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float from_order_key(int k) {
  return k == INT_MAX ? CUDART_NAN_F : __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

template <int kChunk>
__device__ __forceinline__ void fill(float (&v)[kChunk], float x) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) v[j] = x;
}

// v = heads [c0, c0 + kChunk) of the row at p (p points at head c0); heads
// at or past h read -inf.  kVec4: h % 4 == 0 and p 16-byte aligned.
template <int kChunk, bool kVec4, bool kL2>
__device__ __forceinline__ void load_heads(const float* p, int c0, int h,
                                           float (&v)[kChunk]) {
  if (kVec4) {
#pragma unroll
    for (int j = 0; j < kChunk; j += 4) {
      float4 q = make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F,
                             -CUDART_INF_F);
      if (c0 + j < h) {
        const float4* a = reinterpret_cast<const float4*>(p + j);
        q = kL2 ? __ldcg(a) : __ldg(a);
      }
      v[j] = q.x;
      v[j + 1] = q.y;
      v[j + 2] = q.z;
      v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      v[j] = c0 + j < h ? (kL2 ? __ldcg(p + j) : __ldg(p + j))
                        : -CUDART_INF_F;
    }
  }
}

template <int kChunk, bool kVec4>
__device__ __forceinline__ void store_heads(float* p, int c0, int h,
                                            const float (&v)[kChunk]) {
  if (kVec4) {
#pragma unroll
    for (int j = 0; j < kChunk; j += 4) {
      if (c0 + j < h) {
        *reinterpret_cast<float4*>(p + j) =
            make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (c0 + j < h) p[j] = v[j];
    }
  }
}

// every lane ends with the max over the warp's v (REDUX on order keys)
template <int kChunk>
__device__ __forceinline__ void warp_max(float (&v)[kChunk]) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    v[j] = from_order_key(__reduce_max_sync(kFull, order_key(v[j])));
  }
}

// The key of position pos, whose dst entry (read only for an edge) is raw:
// its row inside [first, last), -1 before, n_rows from last on.
__device__ __forceinline__ int key_of(int pos, int raw, int first, int last,
                                      int n_rows) {
  return pos < first ? -1 : pos < last ? raw : n_rows;
}

// A piece of the hub row `row` ([s, t)) has been written to partials by
// lane `writer`: it arrives on the row's counter; the last piece combines
// the row.  Called by the whole warp.
template <int kChunk, bool kVec4>
__device__ void arrive(const Args& a, int row, int s, int t, int first,
                       int lane, int writer) {
  int old = 0;
  if (lane == writer) {
    __threadfence();   // the piece's stores before its arrival
    old = atomicAdd(a.arrivals + row, 1);
  }
  old = __shfl_sync(kFull, old, writer);
  const int ks = s / kC;
  const int n = (t - 1) / kC - ks + 1;
  if (old != n - 1) return;
  __threadfence();   // the other pieces' stores before this warp's loads
  const int slot0 = s == max(ks * kC, first) ? 0 : 1;
  for (int c0 = 0; c0 < a.h; c0 += kChunk) {
    float m[kChunk];
    fill(m, -CUDART_INF_F);
    for (int i = lane; i < n; i += 32) {
      const int64_t at = 2 * static_cast<int64_t>(ks + i) + (i == 0 ? slot0 : 0);
      float v[kChunk];
      load_heads<kChunk, kVec4, true>(a.partials + at * a.h + c0, c0, a.h, v);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) m[j] = nan_max(m[j], v[j]);
    }
    warp_max(m);
    if (lane == 0) {
      store_heads<kChunk, kVec4>(a.out + static_cast<int64_t>(row) * a.h + c0,
                                 c0, a.h, m);
    }
  }
  if (lane == 0) a.arrivals[row] = 0;   // ready for the next launch
}

// At H <= 4, at most 96 registers a thread, so that 5 blocks share an SM:
// 660 blocks (337,920 edges) run at once on 132 SMs, and FB15k-237's 533
// blocks take one wave.  Unbounded, ptxas takes 122 registers: 4 blocks an
// SM, and 5 of FB15k-237's blocks would wait for a second wave.
template <int kChunk, bool kVec4>
__global__ void __launch_bounds__(kWarps * 32, kChunk == 4 ? 5 : 1)
segment_max_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k > a.n_edges / kC) return;   // warp-uniform
  const int h = a.h;
  const int n_rows = a.n_rows;
  const int base = k * kC;
  const int p0 = base + kPer * lane;   // the lane's first position

  // ---- round 1: every address from the shape
  const int first = a.indptr[0];
  const int last = a.indptr[n_rows];
  int raw[kPer];
  float v[kPer][kChunk];
  static_assert(kPer == 4, "a lane's dst is one int4");
  if (kVec4 && p0 + kPer <= a.n_edges) {   // dst 16-byte aligned (launcher)
    const int4 q = __ldg(reinterpret_cast<const int4*>(a.dst + p0));
    raw[0] = q.x;
    raw[1] = q.y;
    raw[2] = q.z;
    raw[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      raw[j] = p0 + j < a.n_edges ? __ldg(a.dst + p0 + j) : 0;
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int pos = p0 + j;
    if (pos < a.n_edges) {
      load_heads<kChunk, kVec4, false>(a.logits + static_cast<int64_t>(pos) * h,
                                       0, h, v[j]);
    } else {
      fill(v[j], -CUDART_INF_F);
    }
  }
  // after the chunk, kWin windows of 32 positions (the owner's read-on):
  // the first window's keys and logits (the first head chunk's: a row that
  // ends there, as most rows that cross the chunk's end do, is read on with
  // no second round) and the last key of each; the position before the
  // chunk, and the one kL + 1 - kC before that
  const int p_next = base + kC + lane;
  const int raw_next = p_next < a.n_edges ? __ldg(a.dst + p_next) : 0;
  float v_next[kChunk];
  if (p_next < a.n_edges) {
    load_heads<kChunk, kVec4, false>(
        a.logits + static_cast<int64_t>(p_next) * h, 0, h, v_next);
  } else {
    fill(v_next, -CUDART_INF_F);
  }
  const int p_win = p_next + 31 * (lane + 1);   // the end of window `lane`
  const int raw_win =
      lane < kWin && p_win < a.n_edges ? __ldg(a.dst + p_win) : 0;
  const int raw_before = base > 0 ? __ldg(a.dst + base - 1) : 0;
  const int p_far = base + kC - kL - 1;
  const int raw_far = p_far >= 0 ? __ldg(a.dst + p_far) : 0;
  assert(0 <= first && first <= last && last <= a.n_edges);

  int key[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int pos = p0 + j;
    key[j] = key_of(pos, raw[j], first, last, n_rows);
    assert(pos < first || pos >= last || (0 <= raw[j] && raw[j] < n_rows));
  }
  const int key_next = key_of(p_next, raw_next, first, last, n_rows);
  const int key_before = key_of(base - 1, raw_before, first, last, n_rows);
  const int key_after = __shfl_sync(kFull, key_next, 0);
  const int key_far = key_of(p_far, raw_far, first, last, n_rows);
  const int key_win = key_of(p_win, raw_win, first, last, n_rows);
  // the chunk's first row, if it started in an earlier chunk; its last row,
  // if it runs past the chunk's end (-1: none)
  const int key0 = __shfl_sync(kFull, key[0], 0);
  const int key1 = __shfl_sync(kFull, key[kPer - 1], 31);
  const int lead = key_before >= 0 && key_before < n_rows && key_before == key0
                       ? key_before : -1;
  const int trail = key_after >= 0 && key_after < n_rows && key_after == key1
                        ? key_after : -1;
  // whole without a look at indptr: a first row that ends in the chunk and
  // does not hold position p_far has at most kL edges; a last row that
  // started in the chunk and ends in window w_end after it, at most
  // kC + 32 * kWin = kL (-1: it runs past every window)
  const bool lead_short = lead >= 0 && lead != trail && key_far != lead;
  const unsigned ends = __ballot_sync(kFull, lane < kWin && key_win != trail);
  const int w_end = trail >= 0 && trail != lead && ends ? __ffs(ends) - 1 : -1;

  // ---- round 2, for long rows only: their pointers
  int lead_s = 0, lead_t = 0, trail_s = 0, trail_t = 0;
  if (lead >= 0 && !lead_short) {
    lead_s = a.indptr[lead];
    lead_t = a.indptr[lead + 1];
  }
  if (trail >= 0 && w_end < 0) {
    trail_s = trail == lead ? lead_s : a.indptr[trail];
    trail_t = trail == lead ? lead_t : a.indptr[trail + 1];
  }
  const bool lead_hub = lead >= 0 && !lead_short && lead_t - lead_s > kL;
  const bool trail_hub = trail >= 0 && w_end < 0 && trail_t - trail_s > kL;
  // the owner reads on past the chunk: the last row started here, <= kL
  const bool read_on = trail >= 0 && trail != lead && !trail_hub;
  // the keys of window w_end (the first window's are in hand)
  const int p_end = p_next + 32 * w_end;
  const int key_last_win =
      w_end <= 0 ? key_next
                 : key_of(p_end, p_end < a.n_edges ? __ldg(a.dst + p_end) : 0,
                          first, last, n_rows);

  // the previous position's key, and whether a position closes its row
  const int lane_prev = __shfl_up_sync(kFull, key[kPer - 1], 1);
  const int lane_next = __shfl_down_sync(kFull, key[0], 1);
  int prev[kPer];
  bool tail[kPer];
  int gap_rows = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int pos = p0 + j;
    prev[j] = j > 0 ? key[j > 0 ? j - 1 : 0] : lane > 0 ? lane_prev : key_before;
    const int next = j + 1 < kPer ? key[j + 1 < kPer ? j + 1 : j]
                     : lane < 31 ? lane_next : key_after;
    tail[j] = pos >= first && pos < last && next != key[j];
    assert(prev[j] <= key[j]);
    gap_rows += key[j] - prev[j] - 1 > 0 ? key[j] - prev[j] - 1 : 0;
  }
  // the lane that closes the first row (if it started earlier)
  bool lead_lane = false;
#pragma unroll
  for (int j = 0; j < kPer; ++j) lead_lane |= tail[j] && key[j] == lead;

  // ---- empty rows: -inf for the rows strictly between consecutive keys
  // (-1 before the first edge, n_rows from the end sentinel on)
  float* const out = a.out;
  const bool own_gaps = gap_rows * h <= kLaneGap;
  if (own_gaps && gap_rows > 0) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      for (int i = (prev[j] + 1) * h; i < key[j] * h; ++i) {
        out[i] = -CUDART_INF_F;
      }
    }
  }
  unsigned coop = __ballot_sync(kFull, !own_gaps);
  while (coop) {   // a long run of empty rows: the whole warp writes it
    const int src = __ffs(coop) - 1;
    coop &= coop - 1;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i1 = __shfl_sync(kFull, key[j], src) * h;
      for (int i = (__shfl_sync(kFull, prev[j], src) + 1) * h + lane; i < i1;
           i += 32) {
        out[i] = -CUDART_INF_F;
      }
    }
  }

  // the lanes keyed alike off lanes up, for the scan
  bool same[5];
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const int up = __shfl_up_sync(kFull, key[kPer - 1], 1 << l);
    same[l] = lane >= (1 << l) && up == key[kPer - 1];
  }
  const int lead_writer = __ffs(__ballot_sync(kFull, lead_lane)) - 1;

  // ---- per chunk of heads: scan, write, read on, pieces
  const int lo = max(base, first);
  for (int c0 = 0;;) {
    // within the lane, in edge order
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int pos = p0 + j;
      if (pos < first || pos >= last) fill(v[j], -CUDART_INF_F);
      if (j > 0 && key[j] == key[j > 0 ? j - 1 : 0]) {
#pragma unroll
        for (int q = 0; q < kChunk; ++q) {
          v[j][q] = nan_max(v[j > 0 ? j - 1 : 0][q], v[j][q]);
        }
      }
    }
    // across lanes: a segmented inclusive scan of each lane's last row,
    // keyed on it (keys rise, so an equal key off lanes up means every
    // position between holds the same row)
    float s[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) s[q] = v[kPer - 1][q];
#pragma unroll
    for (int l = 0; l < 5; ++l) {
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        const float x = __shfl_up_sync(kFull, s[q], 1 << l);
        if (same[l]) s[q] = nan_max(x, s[q]);
      }
    }
    // the lanes before carry into this lane's first row
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const float x = __shfl_up_sync(kFull, s[q], 1);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (lane > 0 && key[j] == lane_prev) v[j][q] = nan_max(x, v[j][q]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (tail[j]) {
        if (key[j] != lead) {   // a row that starts and ends here
          store_heads<kChunk, kVec4>(
              out + static_cast<int64_t>(key[j]) * h + c0, c0, h, v[j]);
        } else if (lead_hub) {  // the last piece of a hub
          store_heads<kChunk, kVec4>(
              a.partials + 2 * static_cast<int64_t>(k) * h + c0, c0, h, v[j]);
        }
      }
    }
    // the last row's max over this chunk is lane 31's last position
    if (trail_hub && lane == 31) {
      const int slot = trail == lead || trail_s == lo ? 0 : 1;
      store_heads<kChunk, kVec4>(
          a.partials + (2 * static_cast<int64_t>(k) + slot) * h + c0, c0, h,
          v[kPer - 1]);
    }
    if (read_on) {
      // the owner reads on to the row's end, lanes over edges, 8 windows of
      // 32 at a time: windows 0 .. w_end (their last one read whole and
      // masked by its keys, so that its loads go with the others), else to
      // indptr's end, at most kL - 1 edges; lane 31 adds the chunk's part
      float m[kChunk];
      fill(m, -CUDART_INF_F);
      if (w_end == 0) {
        if (key_next == trail && c0 == 0) {
#pragma unroll
          for (int q = 0; q < kChunk; ++q) m[q] = v_next[q];
        } else if (key_next == trail) {
          load_heads<kChunk, kVec4, false>(
              a.logits + static_cast<int64_t>(p_next) * h + c0, c0, h, m);
        }
      } else if (w_end > 0) {
        for (int w0 = 0; w0 <= w_end; w0 += 8) {
          float x[8][kChunk];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int e = p_next + 32 * (w0 + i);
            if (w0 + i <= w_end && e < a.n_edges) {
              load_heads<kChunk, kVec4, false>(
                  a.logits + static_cast<int64_t>(e) * h + c0, c0, h, x[i]);
            } else {
              fill(x[i], -CUDART_INF_F);
            }
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (w0 + i < w_end || (w0 + i == w_end && key_last_win == trail)) {
#pragma unroll
              for (int q = 0; q < kChunk; ++q) m[q] = nan_max(m[q], x[i][q]);
            }
          }
        }
      } else {
        assert(trail_t <= last);
#pragma unroll 8
        for (int e = p_next; e < trail_t; e += 32) {
          float x[kChunk];
          load_heads<kChunk, kVec4, false>(
              a.logits + static_cast<int64_t>(e) * h + c0, c0, h, x);
#pragma unroll
          for (int q = 0; q < kChunk; ++q) m[q] = nan_max(m[q], x[q]);
        }
      }
      if (lane == 31) {
#pragma unroll
        for (int q = 0; q < kChunk; ++q) m[q] = nan_max(v[kPer - 1][q], m[q]);
      }
      warp_max(m);
      if (lane == 0) {
        store_heads<kChunk, kVec4>(out + static_cast<int64_t>(trail) * h + c0,
                                   c0, h, m);
      }
    }
    c0 += kChunk;
    if (c0 >= h) break;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int pos = p0 + j;
      if (pos >= first && pos < last) {
        load_heads<kChunk, kVec4, false>(
            a.logits + static_cast<int64_t>(pos) * h + c0, c0, h, v[j]);
      }
    }
  }

  // ---- hubs: arrive with this chunk's pieces
  if (lead_hub) {
    assert(first <= lead_s && lead_t <= last);
    arrive<kChunk, kVec4>(a, lead, lead_s, lead_t, first, lane,
                          trail == lead ? 31 : lead_writer);
  }
  if (trail_hub && trail != lead) {
    assert(first <= trail_s && trail_t <= last);
    arrive<kChunk, kVec4>(a, trail, trail_s, trail_t, first, lane, 31);
  }
}

template <int kChunk, bool kVec4>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int n_chunks = a.n_edges / kC + 1;
  const dim3 grid((n_chunks + kWarps - 1) / kWarps);
  segment_max_kernel<kChunk, kVec4><<<grid, kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launches K5 on `stream`; returns the cudaError_t of the launch (0:
// success).  The caller guarantees n_rows > 0, h > 0, n_rows * h < 2**31,
// n_edges + 2 * (kC + kL) < 2**31, and owns every buffer: partials
// (n_edges / kC + 1, 2, h) float32 (ops/segment_max.py:segment_max_schedule),
// arrivals (n_rows,) int32 zeros.
extern "C" int kgc_segment_max(const void* logits, const void* dst,
                               const void* indptr, void* out, void* partials,
                               void* arrivals, int n_rows, int n_edges, int h,
                               void* stream) {
  if (n_rows <= 0 || h <= 0 || n_edges < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(logits), static_cast<const int*>(dst),
               static_cast<const int*>(indptr), static_cast<float*>(out),
               static_cast<float*>(partials), static_cast<int*>(arrivals),
               n_rows, n_edges, h};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float4 logits and int4 dst loads
  const bool vec4 = h % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(logits) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  if (h <= 4) {
    return static_cast<int>(vec4 ? launch<4, true>(a, s)
                                 : launch<4, false>(a, s));
  }
  return static_cast<int>(vec4 ? launch<16, true>(a, s)
                               : launch<16, false>(a, s));
}
