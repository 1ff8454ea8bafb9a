// Kernel K3 of the port: the stacked schedule's fused compose + segment-sum
// (spmm_mode=stacked).
//
//   out[r, :] = sum over indptr[r] <= e < indptr[r+1] of
//               ((x[src[e], :] * norm[e]) * rel_all[rel[e], :]) * etab[e, :]
//
// x (n_ent, d), rel_all (n_rel_rows, d), etab (E, d) and norm (E,) are
// float32; src, rel and dst (E,) int32 over edges sorted by destination row
// dst, indptr (n_rows+1,) int32 its CSR pointers; out (n_rows, d) float32,
// zeros for rows with no edges.  Replaces the TPU kernel
// kgc_gcn_tpu/ops/spmm_pallas.py:_fused_kernel (called through
// _fused_compose_segment_sum), which reads a pre-gathered (E, 128) stream
// xgn = x[src] * norm, builds the relation rows by a hi/lo bfloat16 one-hot
// matmul and sums through a dst one-hot matmul.  None of that carries over:
// on the card the rows are gathered and summed directly.
//
// Bound: memory.  The least traffic is x, rel_all, etab, src, rel, norm and
// indptr read once and out written once,
//   4*(n_ent*d + n_rel_rows*d + E*d + 3*E + n_rows + 1 + n_rows*d) bytes,
// against three multiplies and one add per edge element (0.0362 ms at the
// stacked WN18RR shape: 174,080 edges, 81,886 rows, d 100).  x (16.4 MB
// there) is gathered inside the kernel and stays in the 50 MB L2, so the
// (E, d) xgn stream that the TPU kernel reads is never written or read.
//
// Schedule: two passes over fixed chunks of kChunk = 32 edges (a warp's
// lanes), cut from E alone, with no host sync:
//   * pass A (chunk_compose): chunk k covers edges [k*32, (k+1)*32) and one
//     warp walks it, its lanes over columns (float4 where d % 4 == 0 and the
//     rows are 16-byte aligned: d 100 is 25 float4 lanes).  Lane j first
//     loads edge k*32 + j's src, rel, norm and dst in one coalesced read;
//     __shfl_sync hands each edge's to the warp.  The warp then issues the
//     x, rel_all and etab row loads of kBatch edges together (4 at d 100),
//     before any product, and sums in edge order in float32 registers,
//     closing a row where dst changes.  A row that lies wholly inside the
//     chunk is written to out; only the chunk's first and last rows can be
//     split across chunks, and their partial sums go to carry[k][slot]
//     (slot 0: the row holding edge k*32; slot 1: the chunk's last row, when
//     it starts after k*32).  No warp walks more than 32 edges, whatever the
//     degrees: the padding hubs (rows N-1 and 2N-1, 205 zero-norm edges each
//     at WN18RR) and power-law entities are spread over ceil(deg / 32) + 1
//     warps;
//   * empty rows get their zeros from pass A too, with no memset: the warp
//     holding edge e writes the rows strictly between dst[e-1] and dst[e]
//     (it reads the dst of the edge just before its chunk), the warp holding
//     the first edge the rows before it, the warp holding the last edge the
//     rows after it;
//   * pass B (split_rows) looks only at split rows, as K7's pass B does: a
//     split row ends in exactly one chunk and holds that chunk's first edge.
//     Block x's first warp checks chunks 32x..32x+31, one a lane.  A row
//     cut by one chunk boundary has two partials (3,053 of the 3,055 split
//     rows at WN18RR, 16,059 of 16,064 at FB15k-237): each of its units is
//     an item, and the block's threads take kPairItems items at a time, all
//     their loads in flight.  A row of 3 to 32 partials takes one warp,
//     kFixBatch loads in flight.  A row of more spans more than the block's
//     32 chunks, so no other such row ends beside it: all 8 warps take it,
//     each adding a run of consecutive partials, and the runs' sums are
//     added in run order (the power law's 40,644-edge row: 1,272 partials,
//     runs of 159).  Pass B is a plain second launch on the stream, so it
//     starts once pass A has ended.  Where no edge lies in
//     [indptr[0], indptr[n_rows]), its first block writes every row's
//     zeros.
// The extra traffic is dst (4 bytes an edge: 0.6 % of the bound's bytes at
// WN18RR, 0.9 % at FB15k-237) and the split rows' partials, written and read
// once (4.0 % at WN18RR, 10.6 % at FB15k-237, whose rows of ~19 edges cut
// nearly every chunk boundary; 6.5 % on the power law).  No atomics and no
// memset, and each row's summation order is fixed (edge order within a
// chunk, then the chunks in order, a long row's in fixed runs), so two calls
// give the same bits.  The products are rounded one by one in the plain
// version's order (__fmul_rn is never contracted into the add), so on inputs
// whose products and partial sums are exact the result equals the plain
// version's to the bit.
//
// rel_all is read through the read-only data cache, not staged in shared
// memory: its rows are few (23 at WN18RR, 475 at FB15k-237, 190 KB there) and
// each warp reads at most 32 of them, so staging the table in every block
// would move more bytes than the block's edges read.  etab, read once, is
// loaded with the evict-first hint, so that the gathered rows of x keep
// their place in L2.  out is stored without it: the next ops of the layer
// (the direction weights' products) read it at once.
//
// Registers (ptxas -v, sm_90a): pass A 98 at d 100 (float4, one unit a
// lane), 99 at d 200, 124 / 108 / 102 / 126 on the float path (1 / 2 / 4 /
// 8 units a lane), no spills: 2 blocks of 8 warps an SM.  Pass B 70
// (float4) and 38.  Tried and not kept (on an H100, PERF.md §6): pass A
// capped at 80 registers (3 blocks an SM) spilled and ran 6-10 % slower;
// pass B with one row a warp and 32 chunks a block took its rows one after
// another (7.1 us at WN18RR, 15.6 at FB15k-237, 85 us for the power law's
// row of 1,272 partials in one warp); with 8 chunks a block its 4x more
// blocks ran in 8 waves (9.2 and 21.7 us); pass B as a programmatic
// dependent launch (griddepcontrol) and out stored with the evict-first
// hint, together 2.7 us faster at WN18RR (0.0566 against 0.0593 ms; PERF.md
// §6 splits it), but the training step no faster within its run-to-run
// spread, so neither is worth its code.
//
// The kernels assert on the device that indptr's ends lie inside [0, E],
// that dst rises inside [0, n_rows) and each edge's src and rel lie inside
// their tables, so a bad index faults instead of reading out of bounds.

#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;        // edges per chunk: one a lane
constexpr int kWarps = 8;         // pass A: chunks a block
constexpr int kColFloats = 256;   // columns per blockIdx.y of pass A
constexpr int kFixChunks = 32;    // pass B: chunks a block checks, one a lane
constexpr int kFixWarps = 8;      // pass B: warps a block
constexpr int kFixBatch = 8;      // pass B: a warp's partials' loads in flight
constexpr int kPairItems = 4;     // pass B: a thread's two-partial rows in flight
constexpr unsigned kFull = 0xffffffffu;

// A lane's unit of columns: one float, or four where d % 4 == 0.
template <bool kVec> struct Lanes { using T = float; };
template <> struct Lanes<true> { using T = float4; };

__device__ __forceinline__ float compose(float x, float n, float r, float e) {
  return __fmul_rn(__fmul_rn(__fmul_rn(x, n), r), e);
}
__device__ __forceinline__ float4 compose(float4 x, float n, float4 r,
                                          float4 e) {
  return make_float4(compose(x.x, n, r.x, e.x), compose(x.y, n, r.y, e.y),
                     compose(x.z, n, r.z, e.z), compose(x.w, n, r.w, e.w));
}
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// Edges whose row loads a lane issues together: about 48 floats in flight.
template <bool kVec, int kPer>
__host__ __device__ constexpr int batch() {
  return 16 / (kPer * (kVec ? 4 : 1)) > 1 ? 16 / (kPer * (kVec ? 4 : 1)) : 1;
}

// Writes a lane's units of one row (of out or of the carry).
template <typename T, int kPer>
__device__ __forceinline__ void store_row(T* __restrict__ o,
                                          const T (&acc)[kPer], int v0,
                                          int nv) {
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int v = v0 + 32 * c;
    if (v < nv) o[v] = acc[c];
  }
}

// Zeros for rows [lo, hi) of out (rows without edges).
template <typename T, int kPer>
__device__ __forceinline__ void zero_rows(T* __restrict__ out, int lo, int hi,
                                          int v0, int nv) {
  for (int r = lo; r < hi; ++r) {
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int v = v0 + 32 * c;
      if (v < nv) out[static_cast<int64_t>(r) * nv + v] = zero<T>();
    }
  }
}

// Pass A: one warp per chunk of 32 edges; lane units v0, v0+32, ... of the
// row (nv units: d / 4 float4 or d floats).
template <bool kVec, int kPer>
__global__ void __launch_bounds__(kWarps * 32)
chunk_compose(const float* __restrict__ x, const int* __restrict__ src,
              const float* __restrict__ norm, const float* __restrict__ rel_all,
              const int* __restrict__ rel, const float* __restrict__ etab,
              const int* __restrict__ dst, const int* __restrict__ indptr,
              float* __restrict__ out_f, float* __restrict__ carry_f,
              int n_rows, int n_edges, int d, int n_ent, int n_rel_rows,
              int n_chunks) {
  using T = typename Lanes<kVec>::T;
  constexpr int kBatch = batch<kVec, kPer>();
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= n_chunks) return;   // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int nv = kVec ? d / 4 : d;
  const int v0 = blockIdx.y * (kColFloats / (kVec ? 4 : 1)) + lane;
  static_assert(kPer * 32 * (kVec ? 4 : 1) <= kColFloats,
                "a lane's units lie inside its blockIdx.y");
  const T* xs = reinterpret_cast<const T*>(x);
  const T* rs = reinterpret_cast<const T*>(rel_all);
  const T* es = reinterpret_cast<const T*>(etab);
  T* out = reinterpret_cast<T*>(out_f);
  T* carry_k = reinterpret_cast<T*>(carry_f) + 2 * static_cast<int64_t>(k) * nv;

  // every load that depends on nothing else, issued together: the chunk's
  // metadata (lane j: edge c0 + j), the dst of the edges just before and
  // just after the chunk, and indptr's ends
  const int c0 = k * kChunk;   // k < n_chunks, so c0 < E < 2**31
  const int em = c0 + lane < n_edges ? c0 + lane : n_edges - 1;
  const int m_src = __ldcs(src + em);
  const int m_rel = __ldcs(rel + em);
  const float m_norm = __ldcs(norm + em);
  const int m_dst = dst[em];
  const int before = c0 > 0 ? dst[c0 - 1] : 0;
  const int after = c0 + kChunk < n_edges ? dst[c0 + kChunk] : 0;
  const int first = indptr[0];
  const int last = indptr[n_rows];
  assert(0 <= first && first <= last && last <= n_edges);
  const int e0 = c0 > first ? c0 : first;
  const int end = last - c0 <= kChunk ? last : c0 + kChunk;
  if (e0 >= end) return;   // no row holds an edge outside [first, last)

  int row = __shfl_sync(kFull, m_dst, e0 - c0);
  assert(0 <= row && row < n_rows);
  // edge e0 - 1 lies in [first, last) only when e0 == c0 > first
  const bool opens = e0 == first;
  assert(opens || before <= row);
  zero_rows<T, kPer>(out, opens ? 0 : before + 1, row, v0, nv);
  bool starts = opens || before != row;
  int slot = e0 == c0 ? 0 : 1;
  T acc[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) acc[c] = zero<T>();
  for (int base = e0; base < end; base += kBatch) {
    int ids[kBatch];
    float nm[kBatch];
    T xv[kBatch][kPer], rv[kBatch][kPer], ev[kBatch][kPer];
    // every load is unconditional (past the chunk's end or the row's width
    // it reads the last edge or unit again, unused) so all are in flight
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = base + j < end ? base + j : end - 1;
      const int s = __shfl_sync(kFull, m_src, e - c0);
      const int r = __shfl_sync(kFull, m_rel, e - c0);
      ids[j] = __shfl_sync(kFull, m_dst, e - c0);
      nm[j] = __shfl_sync(kFull, m_norm, e - c0);
      assert(0 <= s && s < n_ent && 0 <= r && r < n_rel_rows);
      const T* xr = xs + static_cast<int64_t>(s) * nv;
      const T* rr = rs + static_cast<int64_t>(r) * nv;
      const T* er = es + static_cast<int64_t>(e) * nv;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int v = v0 + 32 * c < nv ? v0 + 32 * c : nv - 1;
        xv[j][c] = __ldg(xr + v);
        rv[j][c] = __ldg(rr + v);
        ev[j][c] = __ldcs(er + v);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (base + j >= end) break;
      if (ids[j] != row) {   // the row ended inside the chunk
        assert(row < ids[j] && ids[j] < n_rows);
        if (starts) {
          store_row<T, kPer>(out + static_cast<int64_t>(row) * nv, acc, v0,
                             nv);
        } else {
          store_row<T, kPer>(carry_k + slot * nv, acc, v0, nv);
        }
        zero_rows<T, kPer>(out, row + 1, ids[j], v0, nv);
#pragma unroll
        for (int c = 0; c < kPer; ++c) acc[c] = zero<T>();
        row = ids[j];
        starts = true;
        slot = 1;
      }
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        acc[c] = add(acc[c], compose(xv[j][c], nm[j], rv[j][c], ev[j][c]));
      }
    }
  }
  // the chunk's last row is whole if it also ends inside the chunk
  const bool closes = end == last;
  if (starts && (closes || after != row)) {
    store_row<T, kPer>(out + static_cast<int64_t>(row) * nv, acc, v0, nv);
  } else {
    store_row<T, kPer>(carry_k + slot * nv, acc, v0, nv);
  }
  if (closes) zero_rows<T, kPer>(out, row + 1, n_rows, v0, nv);
}

// Sum of partials lo..hi-1 (lo < hi) of a split row, unit v, in order:
// partial 0 is the row's first chunk's slot (carry row first_slot), partial
// j >= 1 slot 0 of chunk k0 + j; kFixBatch loads in flight.
template <typename T>
__device__ __forceinline__ T sum_partials(const T* __restrict__ carry,
                                          int first_slot, int k0, int lo,
                                          int hi, int v, int nv) {
  const auto at = [&](int j) {
    const int64_t slot = j == 0 ? first_slot : 2 * static_cast<int64_t>(k0 + j);
    return carry[slot * nv + v];
  };
  T acc = at(lo);
  for (int base = lo + 1; base < hi; base += kFixBatch) {
    T part[kFixBatch];
    // predicated loads: issued together, ahead of the adds
#pragma unroll
    for (int j = 0; j < kFixBatch; ++j) {
      part[j] = base + j < hi ? at(base + j) : zero<T>();
    }
#pragma unroll
    for (int j = 0; j < kFixBatch; ++j) {
      if (base + j >= hi) break;
      acc = add(acc, part[j]);
    }
  }
  return acc;
}

// Pass B: block x writes the split rows that end in chunks
// kFixChunks*x .. kFixChunks*x + kFixChunks-1 from their partials in chunk
// order.  A row cut by one chunk boundary (two partials, nearly every row at
// WN18RR's and FB15k-237's degrees) is one item a unit: the block's threads
// take the items kPairItems at a time, all their loads in flight.  A row of
// 3 to kFixChunks partials takes one warp.  The one row of more that a
// block can hold (it spans more than kFixChunks chunks, so no other such row
// ends beside it) takes all its warps, each adding a run of consecutive
// partials, the runs' sums then added in run order.  Block 0 writes every
// row's zeros where no edge lies in [indptr[0], indptr[n_rows]).
template <bool kVec>
__global__ void __launch_bounds__(kFixWarps * 32)
split_rows(const int* __restrict__ dst, const int* __restrict__ indptr,
           const float* __restrict__ carry_f, float* __restrict__ out_f,
           int n_rows, int n_edges, int d, int n_chunks) {
  using T = typename Lanes<kVec>::T;
  static_assert(kFixChunks == 32, "one chunk a lane of the first warp");
  __shared__ int row_s[kFixChunks], k0_s[kFixChunks], k1_s[kFixChunks];
  __shared__ int n_s;
  __shared__ T run_s[kFixWarps][32];
  const int first = indptr[0];
  const int last = indptr[n_rows];
  assert(0 <= first && first <= last && last <= n_edges);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == 0) {
    const int p = static_cast<int>(blockIdx.x) * kFixChunks + lane;
    bool ends = false;
    int row = 0, s = 0;
    if (p < n_chunks) {
      const int c0 = p * kChunk;
      // a split row that ends in chunk p started before c0 and holds it
      if (first <= c0 && c0 < last) {
        row = dst[c0];
        assert(0 <= row && row < n_rows);
        s = indptr[row];
        const int t = indptr[row + 1];
        assert(first <= s && s <= c0 && c0 < t && t <= last);
        ends = s < c0 && (t - 1) / kChunk == p;
      }
    }
    const unsigned ballot = __ballot_sync(kFull, ends);
    if (ends) {
      const int idx = __popc(ballot & ((1u << lane) - 1));
      row_s[idx] = row;
      // the first chunk's partial is in slot 0 if the row holds its first
      // edge, else in slot 1: index 2*k0 + slot
      const int k0 = s / kChunk;
      k0_s[idx] = 2 * k0 + (s == k0 * kChunk ? 0 : 1);
      k1_s[idx] = p;
    }
    if (lane == 0) n_s = __popc(ballot);
  }
  __syncthreads();
  const int nv = kVec ? d / 4 : d;
  const T* carry = reinterpret_cast<const T*>(carry_f);
  T* out = reinterpret_cast<T*>(out_f);
  if (first == last) {   // no edge in any row: every row is empty
    if (blockIdx.x == 0) {
      const int64_t n = static_cast<int64_t>(n_rows) * nv;
      for (int64_t i = threadIdx.x; i < n; i += blockDim.x) out[i] = zero<T>();
    }
    return;
  }
  const int n_rows_here = n_s;
  // rows of two partials: (row, unit) items, kPairItems a thread at a time
  const int items = n_rows_here * nv;
  for (int base = threadIdx.x; base < items;
       base += kPairItems * kFixWarps * 32) {
    T a[kPairItems], b[kPairItems];
#pragma unroll
    for (int j = 0; j < kPairItems; ++j) {
      const int i = base + j * kFixWarps * 32;
      const int r = i < items ? i / nv : 0;
      if (i < items && k1_s[r] - (k0_s[r] >> 1) == 1) {
        const int v = i - r * nv;
        a[j] = carry[static_cast<int64_t>(k0_s[r]) * nv + v];
        b[j] = carry[2 * static_cast<int64_t>(k1_s[r]) * nv + v];
      }
    }
#pragma unroll
    for (int j = 0; j < kPairItems; ++j) {
      const int i = base + j * kFixWarps * 32;
      const int r = i < items ? i / nv : 0;
      if (i < items && k1_s[r] - (k0_s[r] >> 1) == 1) {
        const int v = i - r * nv;
        out[static_cast<int64_t>(row_s[r]) * nv + v] = add(a[j], b[j]);
      }
    }
  }
  // rows of 3 to kFixChunks partials: one a warp; the longer row: below
  int longest = -1;   // the same for every thread: read from shared memory
  for (int i = 0; i < n_rows_here; ++i) {
    const int n = k1_s[i] - (k0_s[i] >> 1) + 1;
    if (n > kFixChunks) longest = i;
    if (n < 3 || n > kFixChunks || i % kFixWarps != warp) continue;
    const int k0 = k0_s[i] >> 1;
    T* o = out + static_cast<int64_t>(row_s[i]) * nv;
    for (int v = lane; v < nv; v += 32) {
      o[v] = sum_partials(carry, k0_s[i], k0, 0, n, v, nv);
    }
  }
  if (longest < 0) return;   // uniform across the block
  const int k0 = k0_s[longest] >> 1;
  const int n = k1_s[longest] - k0 + 1;
  const int len = (n + kFixWarps - 1) / kFixWarps;
  const int lo = warp * len;
  const int hi = lo + len < n ? lo + len : n;
  T* o = out + static_cast<int64_t>(row_s[longest]) * nv;
  for (int v0 = 0; v0 < nv; v0 += 32) {
    const int v = v0 + lane;
    if (v < nv && lo < hi) {
      run_s[warp][lane] = sum_partials(carry, k0_s[longest], k0, lo, hi, v,
                                       nv);
    }
    __syncthreads();
    if (warp == 0 && v < nv) {
      T acc = run_s[0][lane];
      for (int w = 1; w < kFixWarps && w * len < n; ++w) {
        acc = add(acc, run_s[w][lane]);
      }
      o[v] = acc;
    }
    __syncthreads();
  }
}

struct Args {
  const float* x;
  const int* src;
  const float* norm;
  const float* rel_all;
  const int* rel;
  const float* etab;
  const int* dst;
  const int* indptr;
  float* out;
  float* carry;
  int n_rows, n_edges, d, n_ent, n_rel_rows, n_chunks;
};

template <bool kVec, int kPer>
cudaError_t launch_passes(const Args& a, cudaStream_t stream) {
  if (a.n_chunks > 0) {   // E == 0: no chunk, pass B writes the zeros
    const dim3 grid((a.n_chunks + kWarps - 1) / kWarps,
                    (a.d + kColFloats - 1) / kColFloats);
    chunk_compose<kVec, kPer><<<grid, kWarps * 32, 0, stream>>>(
        a.x, a.src, a.norm, a.rel_all, a.rel, a.etab, a.dst, a.indptr, a.out,
        a.carry, a.n_rows, a.n_edges, a.d, a.n_ent, a.n_rel_rows, a.n_chunks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int fix_blocks = a.n_chunks > kFixChunks
                             ? (a.n_chunks + kFixChunks - 1) / kFixChunks : 1;
  split_rows<kVec><<<fix_blocks, kFixWarps * 32, 0, stream>>>(
      a.dst, a.indptr, a.carry, a.out, a.n_rows, a.n_edges, a.d, a.n_chunks);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t launch(const Args& a, cudaStream_t s) {
  // units a lane takes in one blockIdx.y: the next power of two >= the
  // row's units over 32, up to kColFloats / 32 floats
  const int nv = kVec ? a.d / 4 : a.d;
  const int cap = kColFloats / (kVec ? 4 : 1);   // units per blockIdx.y
  const int per = ((nv < cap ? nv : cap) + 31) / 32;
  if constexpr (kVec) {
    if (per <= 1) return launch_passes<true, 1>(a, s);
    return launch_passes<true, 2>(a, s);
  } else {
    if (per <= 1) return launch_passes<false, 1>(a, s);
    if (per <= 2) return launch_passes<false, 2>(a, s);
    if (per <= 4) return launch_passes<false, 4>(a, s);
    return launch_passes<false, 8>(a, s);
  }
}

}  // namespace

// Launches K3's two passes on `stream`; returns the cudaError_t of the
// launches (0: success, cudaErrorInvalidValue when `chunk` is not the
// kernel's kChunk).  carry is uninitialised (ceil(n_edges / chunk), 2, d)
// float32 scratch.  Pass B starts once pass A has ended (stream order).  The
// caller guarantees n_rows > 0 and d > 0 and owns every buffer.
extern "C" int kgc_fused_compose(const void* x, const void* src,
                                 const void* norm, const void* rel_all,
                                 const void* rel, const void* etab,
                                 const void* dst, const void* indptr,
                                 void* out, void* carry, int n_rows,
                                 int n_edges, int d, int n_ent, int n_rel_rows,
                                 int chunk, void* stream) {
  if (chunk != kChunk) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks =
      static_cast<int>((static_cast<int64_t>(n_edges) + kChunk - 1) / kChunk);
  const Args a{static_cast<const float*>(x),      static_cast<const int*>(src),
               static_cast<const float*>(norm),   static_cast<const float*>(rel_all),
               static_cast<const int*>(rel),      static_cast<const float*>(etab),
               static_cast<const int*>(dst),      static_cast<const int*>(indptr),
               static_cast<float*>(out),          static_cast<float*>(carry),
               n_rows, n_edges, d, n_ent, n_rel_rows, n_chunks};
  const void* rows[] = {x, rel_all, etab, out, carry};
  bool aligned = true;
  for (const void* p : rows) aligned &= reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = aligned && d % 4 == 0 ? launch<true>(a, s)
                                                : launch<false>(a, s);
  return static_cast<int>(err);
}
