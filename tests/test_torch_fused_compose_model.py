"""A model of kernel K3's two-pass chunk schedule (csrc/fused_compose.cu,
chunk_compose and split_rows), step for step in numpy, held against the
plain version on random CSR layouts drawn by hypothesis and on the layouts
where the rules are tight (rows of one chunk and one edge more, a hub of
many chunks, empty rows, edges outside [indptr[0], indptr[-1]), the stacked
view's padding hubs), and the schedule function
(ops/fused_compose.py:fused_compose_schedule).  The CUDA kernel itself is
held against the plain version in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from kgc_gcn_torch.data.graph import build_graph
from kgc_gcn_torch.ops.fused_compose import (
    FUSED_COMPOSE_CHUNK, fused_compose_reference, fused_compose_schedule)

pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

GROUP = 32   # kFixChunks: the chunks one pass-B block checks, one a lane
WARPS = 8    # kFixWarps: a pass-B block's warps


def pass_a(k, dst, indptr, chunk):
    """Chunk k's work as chunk_compose does it: (runs, zeros), runs the
    (e_lo, e_hi, dest) edge ranges it sums, dest ("out", row) or ("carry",
    k, slot), and zeros the empty rows whose zeros it writes."""
    n_rows = len(indptr) - 1
    first, last = int(indptr[0]), int(indptr[n_rows])
    c0 = k * chunk
    e0 = max(c0, first)
    end = last if last - c0 <= chunk else c0 + chunk
    if e0 >= end:
        return [], []
    row = dst[e0]
    assert 0 <= row < n_rows
    opens = e0 == first            # edge e0 - 1 belongs to no row
    before = dst[c0 - 1] if c0 > 0 else 0
    assert opens or before <= row
    zeros = list(range(0 if opens else before + 1, row))
    starts = opens or before != row
    slot = 0 if e0 == c0 else 1
    runs, lo = [], e0
    for e in range(e0, end):
        if dst[e] != row:                         # the row ended in the chunk
            assert row < dst[e] < n_rows
            dest = ("out", row) if starts else ("carry", k, slot)
            runs.append((lo, e, dest))
            zeros += range(row + 1, dst[e])
            row, lo, starts, slot = dst[e], e, True, 1
    closes = end == last
    whole = starts and (closes or dst[end] != row)
    runs.append((lo, end, ("out", row) if whole else ("carry", k, slot)))
    if closes:
        zeros += range(row + 1, n_rows)
    return runs, zeros


def pass_b(x, dst, indptr, chunk, n_chunks):
    """Pass-B block x as split_rows does it: the split rows it writes, in
    lane order, as (row, carry index 2*k0 + slot of the first partial, last
    chunk k1), and whether it writes every row's zeros."""
    n_rows = len(indptr) - 1
    first, last = int(indptr[0]), int(indptr[n_rows])
    rows = []
    for p in range(x * GROUP, min((x + 1) * GROUP, n_chunks)):
        c0 = p * chunk
        if not first <= c0 < last:
            continue
        row = dst[c0]
        s, t = int(indptr[row]), int(indptr[row + 1])
        assert first <= s <= c0 < t <= last
        if s < c0 and (t - 1) // chunk == p:
            k0 = s // chunk
            rows.append((row, 2 * k0 + (0 if s == k0 * chunk else 1), p))
    return rows, x == 0 and first == last


def two_pass(msg, dst, indptr, chunk):
    """K3's schedule in numpy on precomposed messages: every out row and
    carry slot starts NaN and must be written exactly once, and read only
    after it was written."""
    n_rows, n_edges, d = len(indptr) - 1, len(msg), msg.shape[1]
    n_chunks = -(-n_edges // chunk)
    out = np.full((n_rows, d), np.nan)
    carry = np.full((n_chunks, 2, d), np.nan)

    def store(dest, acc):
        assert np.isnan(dest).all()
        dest[:] = acc

    for k in range(n_chunks):                                   # pass A
        runs, zeros = pass_a(k, dst, indptr, chunk)
        for lo, hi, dest in runs:
            assert 0 < hi - lo <= chunk     # no warp walks more than a chunk
            acc = np.zeros(d)
            for e in range(lo, hi):
                acc = acc + msg[e]
            store(out[dest[1]] if dest[0] == "out"
                  else carry[dest[1], dest[2]], acc)
        for r in zeros:
            store(out[r], 0.0)
    for x in range(max(1, -(-n_chunks // GROUP))):              # pass B
        rows, fill = pass_b(x, dst, indptr, chunk, n_chunks)
        if fill:
            assert not rows
            for r in range(n_rows):
                store(out[r], 0.0)
        partials = [(row, [carry[k_slot // 2, k_slot % 2]]
                     + [carry[k, 0] for k in range(k_slot // 2 + 1, k1 + 1)])
                    for row, k_slot, k1 in rows]
        assert sum(len(parts) > GROUP for _, parts in partials) <= 1
        for row, parts in partials:
            # a row of two partials: one item a unit; of up to GROUP: one
            # warp, in chunk order; the longer row: runs of consecutive
            # partials, one a warp, their sums added in run order
            assert len(parts) >= 2
            size = -(-len(parts) // WARPS) if len(parts) > GROUP else GROUP
            runs = [parts[i:i + size] for i in range(0, len(parts), size)]
            acc = None
            for run in runs:
                run_sum = run[0].copy()
                for part in run[1:]:
                    run_sum = run_sum + part
                acc = run_sum if acc is None else acc + run_sum
            assert not np.isnan(acc).any()
            store(out[row], acc)
    assert not np.isnan(out).any()
    return out


def layout(counts, lead=0, cut=0):
    """dst over lead + E + cut edges (edges before indptr[0] and after
    indptr[-1] belong to no row) and the CSR pointers of ``counts``."""
    counts = np.asarray(counts, dtype=np.int64)
    dst = np.repeat(np.arange(len(counts)), counts)
    indptr = lead + np.concatenate([[0], np.cumsum(counts)])
    ids = np.concatenate([np.zeros(lead, np.int64), dst,
                          np.full(cut, max(len(counts) - 1, 0))])
    return ids, indptr


def check(dst, indptr, chunk, d=3, n_ent=11, n_rel_rows=5):
    """The model against fused_compose_reference on dyadic operands
    (multiples of 2**-3 below 1: every product and partial sum exact, so
    any order gives the same bits)."""
    n_edges, n_rows = len(dst), len(indptr) - 1
    rng = np.random.default_rng(n_edges + 7 * chunk)
    draw = lambda *s: rng.integers(-7, 8, size=s) / 8
    x, rel_all = draw(n_ent, d), draw(n_rel_rows, d)
    etab, norm = draw(n_edges, d), draw(n_edges)
    src = rng.integers(0, n_ent, n_edges)
    rel = rng.integers(0, n_rel_rows, n_edges)
    msg = ((x[src] * norm[:, None]) * rel_all[rel]) * etab
    real = slice(int(indptr[0]), int(indptr[-1]))
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    want = fused_compose_reference(
        f32(x), i32(src[real]), f32(norm[real]), f32(rel_all), i32(rel[real]),
        f32(etab[real]), i32(dst[real]), i32(indptr), n_rows).numpy()
    np.testing.assert_array_equal(two_pass(msg, dst, indptr, chunk), want)


C = 4   # a small chunk, so that layouts of a few dozen edges span many


@pytest.mark.parametrize("name,counts", [
    ("rows_of_c_and_c_plus_1", [C, C + 1, C, 0, C + 1, C - 1]),
    ("row_on_a_chunk_boundary", [C, 3 * C + 1, 1, C]),
    ("row_ends_at_e", [1, 2, 5 * C + 1]),
    ("empty_rows", [0, 0, C + 2, 0, 0, 1, 0, 0]),
    ("one_hub_of_many_chunks", [40 * C + 3]),
    ("hub_between_empty_rows", [0, 2, 0, 33 * C + 1, 0, 0]),
    ("no_edges", [0, 0, 0]),
    ("one_row", [1]),
])
def test_two_pass_model_on_tight_layouts(name, counts):
    check(*layout(counts), C)


@pytest.mark.parametrize("lead,cut", [(0, 9), (3, 0), (C, C), (2 * C + 1, 5)])
def test_two_pass_model_with_edges_outside_the_rows(lead, cut):
    """indptr[0] > 0 and indptr[-1] < E: the edges before and after belong
    to no row (a chunk may then hold no row's edge, or only some)."""
    check(*layout([0, C + 1, 2, 0, 3 * C, 1, 0], lead, cut), C)
    check(*layout([0, 0, 0], lead, cut), C)


def test_two_pass_model_on_the_stacked_views_padding_hubs():
    """The stacked view of a graph whose halves each pad to 64 edges with
    zero-norm edges in rows N-1 and 2N-1 (as the WN18RR view's 205), at
    the kernel's own chunk of 32 edges."""
    rng = np.random.default_rng(3)
    n_ent, n_rel = 20, 3
    tri = np.stack([rng.integers(n_ent, size=75), rng.integers(n_rel, size=75),
                    rng.integers(n_ent, size=75)], axis=1)
    st_ = build_graph(tri, n_ent, n_rel, pad_to=64).stacked
    counts = np.diff(st_.indptr.numpy())
    assert counts[n_ent - 1] > FUSED_COMPOSE_CHUNK      # padding hubs
    assert counts[2 * n_ent - 1] > FUSED_COMPOSE_CHUNK
    check(st_.dst2.numpy().astype(np.int64), st_.indptr.numpy(),
          FUSED_COMPOSE_CHUNK, d=5, n_ent=n_ent, n_rel_rows=2 * n_rel + 1)


@settings(max_examples=40, deadline=None, database=None)
@given(counts=st.lists(st.one_of(st.integers(0, 3), st.integers(0, 80)),
                       min_size=1, max_size=30),
       chunk=st.sampled_from([1, 2, 3, 4, 8, FUSED_COMPOSE_CHUNK]),
       lead=st.integers(0, 5), cut=st.integers(0, 5))
def test_two_pass_model_matches_plain(counts, chunk, lead, cut):
    """Random CSR layouts: empty rows, hubs of many chunks, rows meeting
    inside a chunk, edges outside the rows."""
    check(*layout(counts, lead, cut), chunk)


@settings(max_examples=30, deadline=None, database=None)
@given(counts=st.lists(st.one_of(st.integers(0, 5), st.integers(30, 700)),
                       min_size=1, max_size=20))
def test_schedule_covers_every_edge_and_row_once(counts):
    """At the kernel's chunk, pass A's warps from fused_compose_schedule
    sum every edge once and write each empty row's zeros once, and the rows
    they write whole and pass B's split rows are the non-empty rows, each
    once."""
    dst, indptr = layout(counts)
    e, n_rows = len(dst), len(counts)
    sched = fused_compose_schedule(e, 100)
    chunk = sched.chunk
    assert sched.n_chunks == -(-e // chunk)
    assert sched.carry_shape == (sched.n_chunks, 2, 100)
    covered = np.zeros(e, int)
    written = np.zeros(n_rows, int)
    for k in range(sched.n_chunks):
        runs, zeros = pass_a(k, dst, indptr, chunk)
        for lo, hi, dest in runs:
            covered[lo:hi] += 1
            if dest[0] == "out":
                written[dest[1]] += 1
        written[zeros] += 1
    for x in range(max(1, -(-sched.n_chunks // GROUP))):
        rows, fill = pass_b(x, dst, indptr, chunk, sched.n_chunks)
        written[[row for row, _, _ in rows]] += 1
        written += fill
    np.testing.assert_array_equal(covered, 1)
    np.testing.assert_array_equal(written, 1)


def test_schedule_at_the_stacked_shapes():
    """WN18RR's stacked view (174,080 edges, d 100): 5,440 chunks and a
    4.35 MB carry; FB15k-237's (544,768 edges): 17,024; no edges, no
    chunk."""
    s = fused_compose_schedule(174080, 100)
    assert (s.chunk, s.n_chunks, s.carry_shape) == (32, 5440, (5440, 2, 100))
    assert fused_compose_schedule(544768, 100).n_chunks == 17024
    assert fused_compose_schedule(0, 4).n_chunks == 0
