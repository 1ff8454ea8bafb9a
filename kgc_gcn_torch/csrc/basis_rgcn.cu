// Kernels K7 and K8 of the port: basis-decomposed R-GCN aggregation and its
// backward, over edges sorted by destination row with CSR pointers indptr.
//
// K7 (forward), msg (E, d) f32, a (E, B) f32 -> out (n_rows, B*d) f32:
//   out[n, b*d + j] = sum over indptr[n] <= e < indptr[n+1] of a[e, b] * msg[e, j]
// with zeros for rows that have no edges.  Replaces the TPU kernel
// kgc_gcn_tpu/ops/spmm_pallas.py:_basis_kernel (called through
// _basis_fused_call).
//
// K8 (backward), g (n_rows, B*d) f32 -> d_msg (E, d) f32, d_a (E, B) f32; for
// each edge e with row n = dst[e], with sel = g[n] viewed as (B, d):
//   d_msg[e, j] = sum_b a[e, b] * sel[b, j]
//   d_a[e, b]   = sum_j sel[b, j] * msg[e, j]
// Replaces kgc_gcn_tpu/ops/spmm_pallas.py:_basis_bwd_kernel (called through
// _basis_bwd_call).
//
// What is left of the TPU kernels is what they compute.  The 128-lane
// padding, the hi/lo bf16 split for near-float32 MXU products, the one-hot
// row selection and the per-tile padded edge plan (build_basis_bwd_plan) are
// not carried over.  K7 sums light rows one block each and heavy rows in
// fixed pieces; K8 reads the dst-sorted edges in fixed spans.  Every output
// element is written once, with no atomics and no memset.  Sums run in
// float32 in a fixed order, so results are deterministic.
//
// Bound: memory.  K7 must read msg and a once and write out once,
//   4*(E*d + E*B + n_rows+1 + n_rows*B*d) bytes
// against 2*E*B*d operations; K8 reads dst, msg, a and the rows of g that
// have edges (n_used of them) and writes d_msg, d_a,
//   4*(n_used*B*d + 2*E*d + 2*E*B + E) bytes
// against 4*E*B*d operations.  Both sit below the card's float32 balance of
// operations per byte (67e12 / 3.35e12 = 20), so bytes bound them.
//   * K7, pass A (basis_sum_kernel): a row of at most T edges (the piece
//     length the caller passes, 256 by default) is light, a longer one
//     heavy.  Blocks 0..n_pieces-1 take the pieces [pT, pT + T) of the
//     edge list, cut from E alone, and sum only the heavy rows' edges in
//     them; the blocks after take the rows, n_rows-1 first, and sum each
//     light row whole (zeros for an empty row) and leave heavy rows alone.
//     A heavy row has more than T edges, so a piece holds parts of at most
//     two: the row of its first edge, whose partial goes to carry[p][0]
//     (carry[p][1] if indptr[0] cuts the piece), and a heavy row that
//     starts inside it and so runs to its end, to carry[p][1].  No block
//     walks more than T edges, and the pieces, in the first wave, leave no
//     tail longer than one piece.  A block stages its edges in chunks of up
//     to 32 (msg as one contiguous range, by 16-byte cp.async when d is a
//     multiple of 4; a by 4-byte cp.async into rows padded to 8 bases), all
//     copies of a chunk in flight at once.  Each thread owns kSlots
//     (column j, group of 8 bases) slots and keeps their 8*kSlots sums in
//     registers; per edge it reads msg[e, j] once and the 8 coefficients
//     as two float4 broadcasts.
//   * K7, pass B (basis_fixup_kernel): a heavy row ends in exactly one
//     piece, and holds that piece's first edge.  Block (x, y) checks the
//     32 pieces 32x..32x+31 with one warp's lanes, and for each heavy row
//     that ends in one of them adds its partials in piece order (the first
//     piece's slot, then slot 0 of every later piece) over 128 columns of
//     the row, one a thread (grid.y spreads a row's B*d columns), 32
//     pieces' loads in flight at a time, and writes the row once.  Pass B
//     is a programmatic dependent launch: pass A's blocks let it be
//     scheduled once they have all started, so its blocks find their rows
//     (from dst and indptr, inputs) during pass A's last wave and then wait
//     for pass A's completion; where no row is heavy it costs almost
//     nothing after pass A.  Each row's order is fixed (edge order within
//     a piece, then the pieces in order), so two calls give the same bits.
//     The extra traffic is the heavy rows' partials, at most 2*B*d floats
//     written and read per piece, and dst (two reads a piece); the carry
//     is (n_pieces, 2, B*d) floats of uninitialised scratch, of which only
//     the heavy rows' slots are touched.  At FB15k-237's counts with
//     power-law in-degrees (T 256: 96 heavy rows over 747 pieces, 764
//     partials) that is 18.3 MB written and read, 5.8 % of the bound's
//     bytes; at config 3 only the padding row (about 288 edges) is heavy.
//   * K8: each edge's outputs need only its own row's cotangent, so no sum
//     crosses edges and a row split between blocks needs no carry.  Block
//     x takes the span of kSpan = 64 edges from 64x and cuts it into runs
//     of one row each where dst changes: a row of any degree is spread over
//     ceil(deg/64) + 1 blocks at most, and rows without edges are never
//     read.  The span's msg and a rows and each run's g row are contiguous
//     and arrive by 16-byte cp.async (4-byte where d or B is no multiple of
//     4).  One buffer holds G: each run's g row is copied once the run
//     before it is done, and the blocks sharing an SM (4 at config 3, B 30
//     d 100) hide each other's copies; a second buffer, which overlapped
//     the copy with the run before it, halved the blocks an SM at d 200 and
//     was slower at every shape timed.  Per run, D_msg = A.G and D_a =
//     M.G^T come from one staged G, as register tiles fed by float4
//     shared-memory reads (8 or 5.3 multiply-adds per read), the block's
//     threads taking the d_msg tiles, then from the next warp boundary the
//     d_a tiles.  d_msg rows go out as float4 stores; d_a through shared
//     memory as the span's one contiguous range.  A row split between
//     spans has its g row read once per span (from L2 after the first):
//     about E/64 extra rows, +11 % of the bytes at config 3.
// K8's shared memory grows with B times the columns a block stages
// (bwd_smem_bytes).  Where a whole row of d columns does not fit in one
// block's opt-in maximum (kMaxSmem; B 128 fits d up to 212, B 30 up to
// 556), the block takes d in column windows of W, a multiple of 4 chosen
// by the caller (ops/basis.py:basis_bwd_window), one window after another:
// each window's d_msg columns are complete, and d_a adds the windows' sums
// in window order in shared memory, so the result stays deterministic.  G,
// msg and d_msg are still read or written once; a is read once; the extra
// cost is one pass over the span's runs per window.  B 128 at d 256 takes
// two windows of 128 columns; no window fits above B 436, and the launcher
// refuses such a shape.
//
// The kernels assert on the device that indptr and dst agree and lie in
// range, so a bad input faults instead of reading or writing out of
// bounds, without a host sync on every launch.

#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;        // K7 block
constexpr int kBwdThreads = 256;     // K8 block
constexpr int kGroup = 8;            // K7: bases one slot accumulates
constexpr int kMaxChunk = 32;        // edges staged per pass
constexpr int kFixThreads = 128;     // K7 pass B block
constexpr int kFixPieces = 32;       // K7 pass B: pieces a block checks
constexpr int kFixBatch = 32;        // K7 pass B: pieces' loads in flight
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;     // one block's opt-in maximum (227 KB)

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for all of this thread's copies.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Programmatic dependent launch (sm_90): the primary grid lets the next
// grid in the stream be scheduled once all its blocks have started; the
// dependent grid waits for the primary's completion and memory before it
// reads what the primary wrote.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// K7's work for one block: up to two edge ranges, each summed into one row
// of B*d floats (a row of out, or a slot of the carry).
struct SumJobs {
  int e0[2], e1[2];
  float* dest[2];
  int n;
};

// Pass A's jobs for block x (see the header): piece x's heavy-row parts,
// or light row n_rows-1-(x-n_pieces) whole.  Every thread computes the
// same jobs from the same loads.
__device__ __forceinline__ SumJobs sum_jobs(
    const int* __restrict__ dst, const int* __restrict__ indptr,
    float* __restrict__ out, float* __restrict__ carry, int n_rows,
    int n_edges, int nbd, int piece, int n_pieces) {
  SumJobs j;
  j.n = 0;
  const int x = static_cast<int>(blockIdx.x);
  if (x >= n_pieces) {
    const int row = n_rows - 1 - (x - n_pieces);
    const int e0 = indptr[row];
    const int e1 = indptr[row + 1];
    assert(0 <= e0 && e0 <= e1 && e1 <= n_edges);
    if (e1 - e0 <= piece) {           // a heavy row is pass B's to write
      j.e0[0] = e0;
      j.e1[0] = e1;
      j.dest[0] = out + static_cast<int64_t>(row) * nbd;
      j.n = 1;
    }
    return j;
  }
  const int first = indptr[0];
  const int last = indptr[n_rows];
  assert(0 <= first && first <= last && last <= n_edges);
  const int c0 = x * piece;            // x < n_pieces, so c0 < E < 2**31
  const int e0 = c0 > first ? c0 : first;
  const int pe = last - c0 <= piece ? last : c0 + piece;
  if (e0 >= pe) return j;              // no row holds an edge outside [first, last)
  float* const slots = carry + 2 * static_cast<int64_t>(x) * nbd;
  const int row0 = dst[e0];
  const int row_l = dst[pe - 1];
  assert(0 <= row0 && row0 <= row_l && row_l < n_rows);
  const int s0 = indptr[row0];
  const int t0 = indptr[row0 + 1];
  assert(s0 <= e0 && e0 < t0);
  if (t0 - s0 > piece) {               // slot 0 holds edge c0's row
    j.e0[0] = e0;
    j.e1[0] = t0 < pe ? t0 : pe;
    j.dest[0] = slots + (e0 == c0 ? 0 : nbd);
    j.n = 1;
  }
  if (row_l != row0) {                 // a heavy row starting inside runs to pe
    const int s1 = indptr[row_l];
    const int t1 = indptr[row_l + 1];
    assert(e0 < s1 && s1 < pe && pe <= t1);
    if (t1 - s1 > piece) {
      j.e0[j.n] = s1;
      j.e1[j.n] = pe;
      j.dest[j.n] = slots + nbd;
      ++j.n;
    }
  }
  return j;
}

template <int kSlots, bool kVec>
__global__ void __launch_bounds__(kThreads)
basis_sum_kernel(const float* __restrict__ msg, const float* __restrict__ a,
                 const int* __restrict__ dst, const int* __restrict__ indptr,
                 float* __restrict__ out, float* __restrict__ carry,
                 int n_rows, int n_edges, int d, int nb, int chunk, int piece,
                 int n_pieces) {
  extern __shared__ float4 smem4[];
  const int nb_pad = round_up(nb, kGroup);
  float* a_s = reinterpret_cast<float*>(smem4);   // (chunk, nb_pad), 0 past nb
  float* m_s = a_s + chunk * nb_pad;               // (chunk, d)
  launch_dependents();                 // pass B may take free SMs now
  const SumJobs jobs = sum_jobs(dst, indptr, out, carry, n_rows, n_edges,
                                nb * d, piece, n_pieces);
  if (jobs.n == 0) return;

  const int n_slots = d * (nb_pad / kGroup);
  int col[kSlots], grp[kSlots];
  bool live[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int slot = (blockIdx.y * kSlots + k) * kThreads + threadIdx.x;
    live[k] = slot < n_slots;
    const int s = live[k] ? slot : 0;
    grp[k] = s / d;
    col[k] = s - grp[k] * d;
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < chunk * nb_pad; i += kThreads) {
    if (i % nb_pad >= nb) a_s[i] = 0.f;   // the copies never write these
  }

  for (int job = 0; job < jobs.n; ++job) {
    const int e0 = jobs.e0[job];
    const int e1 = jobs.e1[job];
    float acc[kSlots][kGroup];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
#pragma unroll
      for (int i = 0; i < kGroup; ++i) acc[k][i] = 0.f;
    }
    for (int c0 = e0; c0 < e1; c0 += chunk) {
      const int n = min(chunk, e1 - c0);
      __syncthreads();                   // the previous chunk is consumed
      const float* ms = msg + static_cast<int64_t>(c0) * d;
      if (kVec) {
        for (int i = 4 * threadIdx.x; i < n * d; i += 4 * kThreads)
          cp_async16(m_s + i, ms + i);
      } else {
        for (int i = threadIdx.x; i < n * d; i += kThreads)
          cp_async4(m_s + i, ms + i);
      }
      const float* as = a + static_cast<int64_t>(c0) * nb;
      for (int t = warp; t < n; t += kThreads / 32) {
        for (int b = lane; b < nb; b += 32)
          cp_async4(a_s + t * nb_pad + b, as + t * nb + b);
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      for (int t = 0; t < n; ++t) {
        const float* at = a_s + t * nb_pad;
        const float* mt = m_s + t * d;
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          const float m = mt[col[k]];
          const float4 lo = *reinterpret_cast<const float4*>(at + grp[k] * kGroup);
          const float4 hi = *reinterpret_cast<const float4*>(at + grp[k] * kGroup + 4);
          acc[k][0] = fmaf(lo.x, m, acc[k][0]);
          acc[k][1] = fmaf(lo.y, m, acc[k][1]);
          acc[k][2] = fmaf(lo.z, m, acc[k][2]);
          acc[k][3] = fmaf(lo.w, m, acc[k][3]);
          acc[k][4] = fmaf(hi.x, m, acc[k][4]);
          acc[k][5] = fmaf(hi.y, m, acc[k][5]);
          acc[k][6] = fmaf(hi.z, m, acc[k][6]);
          acc[k][7] = fmaf(hi.w, m, acc[k][7]);
        }
      }
    }
    float* o = jobs.dest[job];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (!live[k]) continue;
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int b = grp[k] * kGroup + i;
        if (b < nb) o[b * d + col[k]] = acc[k][i];
      }
    }
  }
}

// Pass B: block (x, y) writes the heavy rows that end in pieces
// kFixPieces*x .. kFixPieces*x + kFixPieces-1, columns
// y*kFixThreads .. y*kFixThreads + kFixThreads-1 of each, from their
// partials in piece order.  It is launched as pass A's dependent: its
// blocks find their rows from dst and indptr (inputs) while pass A's last
// blocks run, then every block waits for pass A to complete, so that pass
// B's completion implies pass A's for whatever follows in the stream.
__global__ void __launch_bounds__(kFixThreads)
basis_fixup_kernel(const int* __restrict__ dst, const int* __restrict__ indptr,
                   const float* __restrict__ carry, float* __restrict__ out,
                   int n_rows, int n_edges, int nbd, int piece, int n_pieces) {
  __shared__ int row_s[kFixPieces], k0_s[kFixPieces], k1_s[kFixPieces];
  __shared__ int n_s;
  if (threadIdx.x < 32) {
    const int p = static_cast<int>(blockIdx.x) * kFixPieces + threadIdx.x;
    const int first = indptr[0];
    const int last = indptr[n_rows];
    assert(0 <= first && first <= last && last <= n_edges);
    bool ends = false;
    int row = 0, s = 0;
    if (p < n_pieces) {
      const int c0 = p * piece;
      // a heavy row that ends in piece p started before c0 and holds it
      if (first <= c0 && c0 < last) {
        row = dst[c0];
        assert(0 <= row && row < n_rows);
        s = indptr[row];
        const int t = indptr[row + 1];
        assert(s <= c0 && c0 < t);
        ends = t - s > piece && (t - 1) / piece == p;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, ends);
    if (ends) {
      const int idx = __popc(ballot & ((1u << threadIdx.x) - 1));
      row_s[idx] = row;
      // the first piece's partial is in slot 0 if the row holds its first
      // edge, else in slot 1: index 2*k0 + slot
      const int k0 = s / piece;
      k0_s[idx] = 2 * k0 + (s == k0 * piece ? 0 : 1);
      k1_s[idx] = p;
    }
    if (threadIdx.x == 0) n_s = __popc(ballot);
  }
  __syncthreads();
  wait_for_primary();
  const int col = static_cast<int>(blockIdx.y) * kFixThreads + threadIdx.x;
  if (col >= nbd) return;
  for (int r = 0; r < n_s; ++r) {
    const int k0 = k0_s[r] >> 1;
    const int k1 = k1_s[r];
    float acc = carry[static_cast<int64_t>(k0_s[r]) * nbd + col];
    for (int base = k0 + 1; base <= k1; base += kFixBatch) {
      float v[kFixBatch];
      // predicated loads: issued together, ahead of the adds
#pragma unroll
      for (int j = 0; j < kFixBatch; ++j) {
        v[j] = base + j <= k1
                   ? carry[2 * static_cast<int64_t>(base + j) * nbd + col]
                   : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kFixBatch; ++j) {
        if (base + j > k1) break;
        acc += v[j];
      }
    }
    out[static_cast<int64_t>(row_s[r]) * nbd + col] = acc;
  }
}

// K8 works on spans of kSpan consecutive edges, one block each.  Its shared
// memory (floats): one row's cotangent G (nb4 x S), the span's messages M
// (kSpan x S), its coefficients A (kSpan x nb4) and its d_a rows (kSpan x
// nb), then the span's rows and run starts (ints).  nb4 is B rounded up to
// 4; S is d rounded up to a multiple of 4 whose quotient by 4 is odd, so
// that float4 reads of 8 different rows of G or M hit 8 different bank
// groups.  Columns d..S-1 and rows nb..nb4-1 of G, columns
// d..S-1 of M and columns nb..nb4-1 of A are zeros.
constexpr int kSpan = 64;                    // edges per span
constexpr int kSpanWarps = kSpan / 32;       // warps that cut a span into runs
constexpr int kSpanInts = 2 * kSpan + 4;     // rows, run starts + end, ballots
static_assert(kSpan % 32 == 0 && kSpanWarps <= 3 && kSpan <= kBwdThreads,
              "a span is cut into runs by whole warps");

__host__ __device__ inline int bwd_stride(int d) {
  const int s = round_up(d, 4);
  return (s / 4) % 2 ? s : s + 4;
}

__host__ __device__ inline int64_t bwd_smem_bytes(int d, int nb) {
  const int64_t nb4 = round_up(nb, 4);
  const int64_t s = bwd_stride(d);
  return 4 * (nb4 * s + kSpan * s + kSpan * nb4 + kSpan * nb + kSpanInts);
}

// Starts copying `rows` rows of `cols` floats (global row stride gs) to
// shared memory at row stride ss: warps over rows, lanes over columns,
// 16 bytes a copy when kVec (cols, gs, ss and both bases multiples of 4
// floats), else 4.
template <bool kVec>
__device__ __forceinline__ void copy_rows(float* s, int ss, const float* g,
                                          int gs, int rows, int cols) {
  constexpr int w = kVec ? 4 : 1;
  for (int r = threadIdx.x >> 5; r < rows; r += kBwdThreads / 32) {
    for (int c = (threadIdx.x & 31) * w; c < cols; c += 32 * w) {
      if (kVec) {
        cp_async16(s + r * ss + c, g + static_cast<int64_t>(r) * gs + c);
      } else {
        cp_async4(s + r * ss + c, g + static_cast<int64_t>(r) * gs + c);
      }
    }
  }
}

// Zeros columns c0..c1-1 of `rows` rows at stride ss.
__device__ __forceinline__ void zero_cols(float* s, int ss, int rows, int c0,
                                          int c1) {
  for (int r = threadIdx.x >> 5; r < rows; r += kBwdThreads / 32)
    for (int c = c0 + (threadIdx.x & 31); c < c1; c += 32) s[r * ss + c] = 0.f;
}

__device__ __forceinline__ void fma4(float& acc, const float4& x,
                                     const float4& y) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  acc = fmaf(x.w, y.w, acc);
}

// One run: the k span edges t0..t0+k-1, all into the row whose cotangent is
// in gb, over the w columns of the window staged in G and M (d_msg rows at
// stride ld).  Tasks, strided over the block's threads:
//   * d_msg tiles of 4 edges x 4 columns (q the column quad); per basis
//     quad, 4 float4 of G and 4 of A serve 64 multiply-adds;
//   * from the next warp boundary on, d_a tiles of 2 edges x 4 bases
//     (bt + nbq*i, so a warp's lanes read 8 consecutive rows of G); per
//     column quad, 2 float4 of M and 4 of G serve 32 multiply-adds.
// Sums run over the bases (d_msg) or the window's columns (d_a) in order;
// with `add`, d_a adds the window's sums to those of the windows before.
// Edges past the run read valid shared memory and are not stored.
template <bool kVec>
__device__ __forceinline__ void run_products(
    const float* __restrict__ gb, const float* __restrict__ m_s,
    const float* __restrict__ a_s, float* __restrict__ da_s,
    float* __restrict__ dm_span, int t0, int k, int w, int ld, int nb,
    int S, int nb4, bool add) {
  const int Q = S / 4;                 // float4 stride of a row of G or M
  const int d4 = (w + 3) / 4;          // column quads that hold columns < w
  const int nbq = nb4 / 4;
  const float4* g4 = reinterpret_cast<const float4*>(gb);
  const float4* m4 = reinterpret_cast<const float4*>(m_s);
  const float4* a4 = reinterpret_cast<const float4*>(a_s);
  const int m_tasks = ((k + 3) / 4) * d4;
  const int a_first = round_up(m_tasks, 32);
  const int n_tasks = a_first + ((k + 1) / 2) * nbq;
  for (int task = threadIdx.x; task < n_tasks; task += kBwdThreads) {
    if (task < m_tasks) {
      // d_msg[e, j] = sum_b A[e, b] * G[b, j]
      const int et = task / d4;
      const int q = task - et * d4;
      const int tb = t0 + 4 * et;
      int ti[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ti[i] = min(tb + i, kSpan - 1);
      float4 acc[4] = {};
      for (int bq = 0; bq < nbq; ++bq) {
        const float4 g0 = g4[(4 * bq) * Q + q];
        const float4 g1 = g4[(4 * bq + 1) * Q + q];
        const float4 g2 = g4[(4 * bq + 2) * Q + q];
        const float4 g3 = g4[(4 * bq + 3) * Q + q];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 av = a4[ti[i] * nbq + bq];
          acc[i].x = fmaf(av.w, g3.x, fmaf(av.z, g2.x, fmaf(av.y, g1.x,
                     fmaf(av.x, g0.x, acc[i].x))));
          acc[i].y = fmaf(av.w, g3.y, fmaf(av.z, g2.y, fmaf(av.y, g1.y,
                     fmaf(av.x, g0.y, acc[i].y))));
          acc[i].z = fmaf(av.w, g3.z, fmaf(av.z, g2.z, fmaf(av.y, g1.z,
                     fmaf(av.x, g0.z, acc[i].z))));
          acc[i].w = fmaf(av.w, g3.w, fmaf(av.z, g2.w, fmaf(av.y, g1.w,
                     fmaf(av.x, g0.w, acc[i].w))));
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (4 * et + i >= k) break;
        float* o = dm_span + static_cast<int64_t>(tb + i) * ld + 4 * q;
        if (kVec) {
          *reinterpret_cast<float4*>(o) = acc[i];
        } else {
          const float v[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (4 * q + c < w) o[c] = v[c];
        }
      }
    } else if (task >= a_first) {
      // d_a[e, b] = sum_j G[b, j] * M[e, j]
      const int u = task - a_first;
      const int ep = u / nbq;
      const int bt = u - ep * nbq;
      const int ta = t0 + 2 * ep;
      const int r0 = min(ta, kSpan - 1) * Q;
      const int r1 = min(ta + 1, kSpan - 1) * Q;
      float acc[2][4] = {};
      for (int q = 0; q < d4; ++q) {
        const float4 m0 = m4[r0 + q];
        const float4 m1 = m4[r1 + q];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 gv = g4[(bt + nbq * i) * Q + q];
          fma4(acc[0][i], m0, gv);
          fma4(acc[1][i], m1, gv);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (2 * ep + e >= k) break;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int b = bt + nbq * i;
          if (b < nb) {
            float& o = da_s[(ta + e) * nb + b];
            o = add ? o + acc[e][i] : acc[e][i];
          }
        }
      }
    }
  }
}

// Block x takes the span of edges [64x, 64x + 64) and cuts it into runs
// where dst changes.  It walks the columns of d in windows of W (W = d when
// the whole row fits), and each window's runs in order.  The span's A and
// the first window's M arrive with the first run's G, by cp.async; each
// later run's G row (and a new window's M) is copied once the run before it
// has consumed the buffer (one buffer, so that several blocks share an SM
// and hide each other's copies).  d_msg goes out from registers as float4
// rows; d_a, summed in shared memory over the windows in order, goes out
// as the span's one contiguous range at the end.
template <bool kVec>
__global__ void __launch_bounds__(kBwdThreads)
basis_bwd_kernel(const float* __restrict__ g, const float* __restrict__ msg,
                 const float* __restrict__ a, const int* __restrict__ dst,
                 float* __restrict__ d_msg, float* __restrict__ d_a,
                 int n_rows, int n_edges, int d, int nb, int W,
                 bool aligned) {
  extern __shared__ float4 smem4[];
  const int S = bwd_stride(W);
  const int nb4 = round_up(nb, 4);
  float* g_s = reinterpret_cast<float*>(smem4);    // (nb4, S)
  float* m_s = g_s + nb4 * S;                       // (kSpan, S)
  float* a_s = m_s + kSpan * S;                     // (kSpan, nb4)
  float* da_s = a_s + kSpan * nb4;                  // (kSpan, nb)
  int* row_s = reinterpret_cast<int*>(da_s + kSpan * nb);   // (kSpan)
  int* run_s = row_s + kSpan;                       // (kSpan + 1)
  unsigned* head_s = reinterpret_cast<unsigned*>(run_s + kSpan + 1);
  const int tid = threadIdx.x;
  const int e0 = static_cast<int>(blockIdx.x) * kSpan;
  const int n = min(kSpan, n_edges - e0);

  zero_cols(g_s, S, nb4, W, S);
  zero_cols(g_s + nb * S, S, nb4 - nb, 0, S);
  zero_cols(m_s, S, kSpan, W, S);
  zero_cols(a_s, nb4, kSpan, nb, nb4);

  // runs: edge t heads one where its row differs from edge t-1's
  bool head = false;
  if (tid < kSpan) {
    int row = -1;
    if (tid < n) {
      row = dst[e0 + tid];
      assert(0 <= row && row < n_rows);
      head = tid == 0 || dst[e0 + tid - 1] != row;
    }
    row_s[tid] = row;
    const unsigned ballot = __ballot_sync(0xffffffffu, head);
    if ((tid & 31) == 0) head_s[tid >> 5] = ballot;
  }
  __syncthreads();
  int n_runs = 0;
#pragma unroll
  for (int w = 0; w < kSpanWarps; ++w) n_runs += __popc(head_s[w]);
  if (head) {
    int idx = __popc(head_s[tid >> 5] & ((1u << (tid & 31)) - 1));
    for (int w = 0; w < (tid >> 5); ++w) idx += __popc(head_s[w]);
    run_s[idx] = tid;
  }
  if (tid == 0) run_s[n_runs] = n;
  __syncthreads();

  const bool vec_a = aligned && nb % 4 == 0;
  const int n_win = (d + W - 1) / W;
  auto width = [&](int w) { return min(W, d - w * W); };
  auto load_g = [&](int w, int r) {
    const int row = row_s[run_s[r]];
    copy_rows<kVec>(g_s, S, g + static_cast<int64_t>(row) * nb * d + w * W,
                    d, nb, width(w));
  };
  auto load_m = [&](int w) {
    copy_rows<kVec>(m_s, S, msg + static_cast<int64_t>(e0) * d + w * W, d, n,
                    width(w));
  };
  load_m(0);
  if (vec_a) {
    copy_rows<true>(a_s, nb4, a + static_cast<int64_t>(e0) * nb, nb, n, nb);
  } else {
    copy_rows<false>(a_s, nb4, a + static_cast<int64_t>(e0) * nb, nb, n, nb);
  }
  load_g(0, 0);
  cp_async_commit();

  float* dm_span = d_msg + static_cast<int64_t>(e0) * d;
  for (int w = 0; w < n_win; ++w) {
    for (int r = 0; r < n_runs; ++r) {
      cp_async_wait_all();                // this run's G (and M, A) are here
      __syncthreads();
      run_products<kVec>(g_s, m_s, a_s, da_s, dm_span + w * W, run_s[r],
                         run_s[r + 1] - run_s[r], width(w), d, nb, S, nb4,
                         w > 0);
      __syncthreads();                    // G (and M) are consumed
      if (r + 1 < n_runs) {
        load_g(w, r + 1);
        cp_async_commit();
      } else if (w + 1 < n_win) {
        // a narrower last window reads zeros past its columns
        zero_cols(g_s, S, nb, width(w + 1), W);
        zero_cols(m_s, S, kSpan, width(w + 1), W);
        load_m(w + 1);
        load_g(w + 1, 0);
        cp_async_commit();
      }
    }
  }

  // the span's d_a rows: one contiguous range of n*nb floats, 16-byte
  // aligned since e0 is a multiple of 4
  float* da = d_a + static_cast<int64_t>(e0) * nb;
  const int total = n * nb;
  const int n4 = aligned ? total / 4 : 0;
  for (int i = tid; i < n4; i += kBwdThreads)
    reinterpret_cast<float4*>(da)[i] = reinterpret_cast<const float4*>(da_s)[i];
  for (int i = 4 * n4 + tid; i < total; i += kBwdThreads) da[i] = da_s[i];
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

struct SumArgs {
  const float* msg;
  const float* a;
  const int* dst;
  const int* indptr;
  float* out;
  float* carry;
  int n_rows, n_edges, d, nb, piece, n_pieces;
  bool dependent;   // pass B as a programmatic dependent launch
};

// Pass A over n_pieces + n_rows blocks (pieces first), then pass B.
template <int kSlots, bool kVec>
cudaError_t launch_sum(const SumArgs& g, int n_slots, int chunk, int smem,
                       cudaStream_t stream) {
  const auto kernel = basis_sum_kernel<kSlots, kVec>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.n_pieces + g.n_rows,
                  (n_slots + kThreads * kSlots - 1) / (kThreads * kSlots));
  kernel<<<grid, kThreads, smem, stream>>>(
      g.msg, g.a, g.dst, g.indptr, g.out, g.carry, g.n_rows, g.n_edges, g.d,
      g.nb, chunk, g.piece, g.n_pieces);
  err = cudaGetLastError();
  if (err != cudaSuccess || g.n_pieces == 0) return err;
  const int nbd = g.nb * g.d;
  cudaLaunchConfig_t fix = {};
  fix.gridDim = dim3((g.n_pieces + kFixPieces - 1) / kFixPieces,
                     (nbd + kFixThreads - 1) / kFixThreads);
  fix.blockDim = dim3(kFixThreads);
  fix.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  fix.attrs = &attr;
  fix.numAttrs = g.dependent ? 1 : 0;
  return cudaLaunchKernelEx(&fix, basis_fixup_kernel, g.dst, g.indptr,
                            static_cast<const float*>(g.carry), g.out,
                            g.n_rows, g.n_edges, nbd, g.piece, g.n_pieces);
}

template <bool kVec>
cudaError_t launch_slots(const SumArgs& g, int n_slots, int chunk, int smem,
                         cudaStream_t s) {
  const int per = (n_slots + kThreads - 1) / kThreads;
  if (per <= 1) return launch_sum<1, kVec>(g, n_slots, chunk, smem, s);
  if (per <= 2) return launch_sum<2, kVec>(g, n_slots, chunk, smem, s);
  if (per <= 4) return launch_sum<4, kVec>(g, n_slots, chunk, smem, s);
  return launch_sum<8, kVec>(g, n_slots, chunk, smem, s);
}

}  // namespace

// Launches K7's two passes on `stream`; returns the cudaError_t of the
// launches (0: success).  Rows of more than `piece` edges are summed in
// pieces of `piece` edges: carry is uninitialised (ceil(n_edges / piece), 2,
// nb * d) float32 scratch.  With `dependent` pass B is a programmatic
// dependent launch; without it, it starts once pass A has ended, so that a
// profiler's interval for each pass is that pass's own time.  The caller
// guarantees n_rows > 0, d > 0, nb > 0, piece > 0 and owns every buffer.
extern "C" int kgc_basis_sum(const void* msg, const void* a, const void* dst,
                             const void* indptr, void* out, void* carry,
                             int n_rows, int n_edges, int d, int nb, int piece,
                             int dependent, void* stream) {
  const int nb_pad = round_up(nb, kGroup);
  const int row_bytes = 4 * (nb_pad + d);
  int chunk = kDefaultSmem / row_bytes;
  if (chunk < 1) chunk = kMaxSmem / row_bytes;
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (chunk > kMaxChunk) chunk = kMaxChunk;
  const int smem = chunk * row_bytes;
  const int n_slots = d * (nb_pad / kGroup);
  const int n_pieces =
      static_cast<int>((static_cast<int64_t>(n_edges) + piece - 1) / piece);
  const SumArgs g{static_cast<const float*>(msg), static_cast<const float*>(a),
                  static_cast<const int*>(dst), static_cast<const int*>(indptr),
                  static_cast<float*>(out), static_cast<float*>(carry),
                  n_rows, n_edges, d, nb, piece, n_pieces, dependent != 0};
  const bool vec = reinterpret_cast<uintptr_t>(msg) % 16 == 0 && d % 4 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = vec ? launch_slots<true>(g, n_slots, chunk, smem, s)
                              : launch_slots<false>(g, n_slots, chunk, smem, s);
  return static_cast<int>(err);
}

// Launches K8 on `stream`; returns the cudaError_t of the launch (0: success,
// cudaErrorInvalidValue when `window` is neither d nor a multiple of 4 below
// d, or when the shared memory a span needs at that window,
// bwd_smem_bytes(window, nb), exceeds kMaxSmem).  A block takes the columns
// of d `window` at a time.  dst holds each edge's row in [0, n_rows); rows
// need not be sorted, but sorted rows make long runs.  The caller
// guarantees n_edges > 0, d > 0, nb > 0 and owns every buffer.
extern "C" int kgc_basis_bwd(const void* g, const void* msg, const void* a,
                             const void* dst, void* d_msg, void* d_a,
                             int n_rows, int n_edges, int d, int nb,
                             int window, void* stream) {
  if (window < 1 || window > d || (window < d && window % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem = bwd_smem_bytes(window, nb);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {g, msg, a, d_msg, d_a};
  bool aligned = true;
  for (const void* p : ptrs) aligned &= reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const bool vec = aligned && d % 4 == 0;
  const auto kernel = vec ? basis_bwd_kernel<true> : basis_bwd_kernel<false>;
  const cudaError_t err = allow_smem(kernel, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned n_spans =
      static_cast<unsigned>((static_cast<int64_t>(n_edges) + kSpan - 1) / kSpan);
  kernel<<<n_spans, kBwdThreads, static_cast<int>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(msg),
      static_cast<const float*>(a), static_cast<const int*>(dst),
      static_cast<float*>(d_msg), static_cast<float*>(d_a), n_rows, n_edges, d,
      nb, window, aligned);
  return static_cast<int>(cudaGetLastError());
}
