"""A model of kernel K7's two-pass schedule (csrc/basis_rgcn.cu,
basis_sum_kernel and basis_fixup_kernel), step for step in numpy, held
against the plain version on random CSR layouts drawn by hypothesis and on
the layouts where the rules are tight; the schedule function
(ops/basis.py:basis_sum_schedule) against the edges it must cover; and the
column windows of K8 (ops/basis.py:basis_bwd_window) at the boundaries of
its shared memory.  The CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from kgc_gcn_torch.ops.basis import (
    BASIS_BWD_MAX_SMEM, basis_bwd_smem_bytes, basis_bwd_window,
    basis_segment_sum_reference, basis_sum_schedule)

pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

GROUP = 32   # kFixPieces: the pieces one pass-B block checks, one per lane


def pass_a_jobs(x, dst, indptr, n_edges, piece, n_pieces):
    """Block x's jobs as sum_jobs computes them: (e0, e1, dest), dest
    ("out", row) or ("carry", piece, slot)."""
    n_rows = len(indptr) - 1
    if x >= n_pieces:
        row = n_rows - 1 - (x - n_pieces)
        e0, e1 = int(indptr[row]), int(indptr[row + 1])
        assert 0 <= e0 <= e1 <= n_edges
        return [(e0, e1, ("out", row))] if e1 - e0 <= piece else []
    first, last = int(indptr[0]), int(indptr[n_rows])
    c0 = x * piece
    e0 = max(c0, first)
    pe = last if last - c0 <= piece else c0 + piece
    if e0 >= pe:
        return []
    jobs = []
    row0, row_l = dst[e0], dst[pe - 1]
    assert 0 <= row0 <= row_l < n_rows
    s0, t0 = int(indptr[row0]), int(indptr[row0 + 1])
    assert s0 <= e0 < t0
    if t0 - s0 > piece:
        jobs.append((e0, min(t0, pe), ("carry", x, 0 if e0 == c0 else 1)))
    if row_l != row0:
        s1, t1 = int(indptr[row_l]), int(indptr[row_l + 1])
        assert e0 < s1 < pe <= t1
        if t1 - s1 > piece:
            jobs.append((s1, pe, ("carry", x, 1)))
    return jobs


def pass_b_rows(x, dst, indptr, piece, n_pieces):
    """The heavy rows that pass-B block x writes, in lane order: (row,
    carry index 2*k0 + slot of the first partial, last piece k1)."""
    n_rows = len(indptr) - 1
    first, last = int(indptr[0]), int(indptr[n_rows])
    rows = []
    for p in range(x * GROUP, min((x + 1) * GROUP, n_pieces)):
        c0 = p * piece
        if not first <= c0 < last:
            continue
        row = dst[c0]
        s, t = int(indptr[row]), int(indptr[row + 1])
        assert s <= c0 < t
        if t - s > piece and (t - 1) // piece == p:
            k0 = s // piece
            rows.append((row, 2 * k0 + (0 if s == k0 * piece else 1), p))
    return rows


def two_pass_basis_sum(msg, a, dst, indptr, piece):
    """K7's schedule in numpy: every out row and carry slot starts NaN and
    must be written exactly once, and read only after it was written."""
    n_rows, n_edges = len(indptr) - 1, len(msg)
    nbd = a.shape[1] * msg.shape[1]
    n_pieces = -(-n_edges // piece)
    out = np.full((n_rows, nbd), np.nan)
    carry = np.full((n_pieces, 2, nbd), np.nan)

    def store(dest, acc):
        assert np.isnan(dest).all()
        dest[:] = acc

    for x in range(n_pieces + n_rows):                         # pass A
        jobs = pass_a_jobs(x, dst, indptr, n_edges, piece, n_pieces)
        assert len(jobs) <= 2
        for e0, e1, dest in jobs:
            assert e1 - e0 <= piece           # no block walks more than T
            acc = np.zeros(nbd)
            for e in range(e0, e1):
                acc = acc + np.outer(a[e], msg[e]).ravel()
            store(out[dest[1]] if dest[0] == "out"
                  else carry[dest[1], dest[2]], acc)
    for x in range(-(-n_pieces // GROUP)):                      # pass B
        for row, k_slot, k1 in pass_b_rows(x, dst, indptr, piece, n_pieces):
            acc = carry[k_slot // 2, k_slot % 2].copy()
            for k in range(k_slot // 2 + 1, k1 + 1):
                acc += carry[k, 0]
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


def check(counts, piece, lead=0, cut=0, d=2, nb=3):
    dst, indptr = layout(counts, lead, cut)
    n_edges = len(dst)
    rng = np.random.default_rng(n_edges)
    msg = rng.integers(-8, 9, size=(n_edges, d)).astype(np.float64)
    a = rng.integers(-4, 5, size=(n_edges, nb)).astype(np.float64)
    n_rows = len(counts)
    real = slice(lead, n_edges - cut)
    want = basis_segment_sum_reference(
        torch.from_numpy(msg[real]).float(), torch.from_numpy(a[real]).float(),
        torch.from_numpy(dst[real]), None, n_rows).numpy()
    np.testing.assert_array_equal(
        two_pass_basis_sum(msg, a, dst, indptr, piece), want)


T = 4   # a small piece, so that layouts of a few dozen edges hold heavy rows


@pytest.mark.parametrize("name,counts", [
    ("rows_of_t_and_t_plus_1", [T, T + 1, T, 0, T + 1]),
    ("two_heavy_rows_meet_in_a_piece", [2, T + 3, T + 2, 1]),
    ("heavy_row_on_a_piece_boundary", [T, 3 * T + 1, 1]),
    ("heavy_row_ends_at_e", [1, 2, 5 * T + 1]),
    ("empty_rows", [0, 0, T + 2, 0, 0, 1, 0]),
    ("padding_row_last", [1, 3, 0, 2, 1, 2 * T + 3]),
    ("one_hub_of_many_pieces", [40 * T + 3]),
    ("no_edges", [0, 0, 0]),
])
def test_two_pass_model_on_tight_layouts(name, counts):
    check(counts, T)


@settings(max_examples=40, deadline=None, database=None)
@given(counts=st.lists(st.one_of(st.integers(0, 3), st.integers(0, 60)),
                       min_size=1, max_size=30),
       piece=st.sampled_from([1, 2, 3, 4, 8, 32]),
       lead=st.integers(0, 5), cut=st.integers(0, 5))
def test_two_pass_model_matches_plain(counts, piece, lead, cut):
    """Random CSR layouts (empty rows, hubs of many pieces, heavy rows
    meeting inside a piece), also with edges before indptr[0] (``lead``) or
    after indptr[-1] (``cut``) that belong to no row."""
    check(counts, piece, lead, cut)


@settings(max_examples=30, deadline=None, database=None)
@given(counts=st.lists(st.one_of(st.integers(0, 40), st.integers(250, 1300)),
                       min_size=1, max_size=12))
def test_schedule_covers_every_heavy_edge_once(counts):
    """At the default piece length, pass A's blocks from basis_sum_schedule
    cover every edge of every heavy row once and no light row's edge, and
    pass B's blocks write each heavy row once."""
    dst, indptr = layout(counts)
    e, n_rows = len(dst), len(counts)
    sched = basis_sum_schedule(e, 100, 30)
    piece = sched.piece
    assert sched.n_pieces == -(-e // piece)
    assert sched.carry_shape == (sched.n_pieces, 2, 3000)
    covered = np.zeros(e, int)
    for x in range(sched.n_pieces):
        for e0, e1, _ in pass_a_jobs(x, dst, indptr, e, piece,
                                     sched.n_pieces):
            covered[e0:e1] += 1
    heavy = np.diff(indptr) > piece
    np.testing.assert_array_equal(covered, heavy[dst].astype(int))
    written = [row for x in range(-(-sched.n_pieces // GROUP))
               for row, _, _ in pass_b_rows(x, dst, indptr, piece,
                                            sched.n_pieces)]
    assert sorted(written) == list(np.flatnonzero(heavy))


def test_schedule_at_config3():
    """BASELINE config 3's in-half (E 272,384, B 30, d 100): 1,064 pieces
    and a 25.5 MB carry; at d 200 twice the carry; no edges, no piece."""
    s = basis_sum_schedule(272384, 100, 30)
    assert (s.piece, s.n_pieces, s.carry_shape) == (256, 1064, (1064, 2, 3000))
    assert basis_sum_schedule(272384, 200, 30).carry_shape == (1064, 2, 6000)
    assert basis_sum_schedule(0, 4, 2).n_pieces == 0


@pytest.mark.parametrize("d,nb,window", [
    (556, 30, 556), (557, 30, 280), (212, 128, 212), (213, 128, 108),
    (256, 128, 128), (100, 30, 100), (200, 30, 200), (601, 64, 304),
    (1500, 30, 500), (3, 436, 3), (4, 436, 4), (4, 437, 0), (300, 437, 0)])
def test_basis_bwd_window_at_its_boundaries(d, nb, window):
    """A K8 block stages a whole row where it fits in shared memory (B 30:
    d up to 556; B 128: d up to 212), else d in the fewest column windows
    that fit (B 128 at d 256, which the JAX package's kernel trains: two of
    128); above B 436 nothing fits.  The launcher's windows (``width`` in
    basis_bwd_kernel) cover each column once, the last one possibly
    narrower."""
    assert basis_bwd_window(d, nb) == window
    whole = basis_bwd_smem_bytes(d, nb) <= BASIS_BWD_MAX_SMEM
    assert (window == d) is whole
    if window == 0:
        assert basis_bwd_smem_bytes(4, nb) > BASIS_BWD_MAX_SMEM
        return
    assert basis_bwd_smem_bytes(window, nb) <= BASIS_BWD_MAX_SMEM
    assert window == d or window % 4 == 0
    n_win = -(-d // window)
    widths = [min(window, d - w * window) for w in range(n_win)]
    assert min(widths) > 0 and sum(widths) == d
    if n_win > 1:                         # one window fewer would not fit
        wider = -(-d // (n_win - 1))
        assert (basis_bwd_smem_bytes(-(-wider // 4) * 4, nb)
                > BASIS_BWD_MAX_SMEM)
