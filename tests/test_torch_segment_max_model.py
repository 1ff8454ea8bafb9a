"""A model of kernel K5's schedule (csrc/segment_max.cu), step for step in
numpy: the chunk, key, owner, limit, piece and empty-row rules, the slots of
the partials and the arrival counters, over ``segment_max_schedule``.  It
is held bit for bit against ``segment_max_reference`` on CSR layouts drawn
by hypothesis and on the layouts where the rules are tight.  The CUDA
kernel itself is held against the plain version in tests/test_torch_cuda.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from kgc_gcn_torch.ops.segment_max import (
    SEGMENT_MAX_CHUNK, SEGMENT_MAX_LIMIT, segment_max_reference,
    segment_max_schedule)

pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

INT_MAX = 2**31 - 1


def nan_max(a, b):
    """The kernel's max: a NaN of either operand wins, ``a`` first."""
    return np.where(np.isnan(a) | (a > b), a, b)


def fold(values, start):
    """Max of ``values`` rows onto ``start`` in order, as nan_max chains."""
    acc = start.copy()
    for x in values:
        acc = nan_max(acc, x)
    return acc


def model_segment_max(logits, dst, indptr, n_rows, chunk, limit, seed=0):
    """csrc/segment_max.cu's rules, warp by warp in a random order (the
    order in which the card runs them is unknown): every out element and
    partial must be written exactly once, a partial read only after it was
    written, and every arrival counter left at 0."""
    e, h = logits.shape
    # the kernel's rule: the limit is the chunk plus 1 to 32 windows of 32
    assert (limit - chunk) % 32 == 0 and 32 <= limit - chunk <= 1024
    n_chunks = e // chunk + 1
    partials_shape = (n_chunks, 2, h)
    if chunk == SEGMENT_MAX_CHUNK:
        assert segment_max_schedule(e, h) == (n_chunks, partials_shape)
    first, last = int(indptr[0]), int(indptr[n_rows])
    assert 0 <= first <= last <= e
    out = np.full((n_rows, h), np.nan, np.float32)
    written = np.zeros(n_rows, int)
    partials = np.full(partials_shape, np.nan, np.float32)
    p_written = np.zeros(partials_shape[:2], bool)
    arrivals = np.zeros(n_rows, int)
    ninf = np.full(h, -np.inf, np.float32)

    def key_of(pos):
        if pos < first:
            return -1
        if pos < last:
            assert 0 <= dst[pos] < n_rows
            return int(dst[pos])
        return n_rows if pos == last else INT_MAX

    def store(r, v):
        written[r] += 1
        out[r] = v

    def put(k, slot, v):
        assert not p_written[k, slot]
        p_written[k, slot] = True
        partials[k, slot] = v

    def arrive(r, s, t):
        ks, kt = s // chunk, (t - 1) // chunk
        arrivals[r] += 1
        if arrivals[r] < kt - ks + 1:
            return
        slot0 = 0 if s == max(ks * chunk, first) else 1
        pieces = [(ks + i, slot0 if i == 0 else 0) for i in range(kt - ks + 1)]
        assert all(p_written[p] for p in pieces)
        store(r, fold([partials[p] for p in pieces], ninf))
        arrivals[r] = 0

    order = np.random.default_rng(seed).permutation(n_chunks)
    for k in order:
        base = k * chunk
        keys = [key_of(p) for p in range(base, base + chunk)]
        key_before, key_after = key_of(base - 1), key_of(base + chunk)
        lead = key_before if 0 <= key_before < n_rows and key_before == keys[0] \
            else -1
        trail = key_after if 0 <= key_after < n_rows and key_after == keys[-1] \
            else -1
        # whole without indptr: the first row ends in the chunk and does not
        # hold position base + chunk - limit - 1; the last row started here
        # and ends in window w_end of the (limit - chunk) / 32 windows of 32
        # positions after the chunk (-1: past them all)
        lead_short = lead >= 0 and lead != trail and \
            key_of(base + chunk - limit - 1) != lead
        ends = [w for w in range((limit - chunk) // 32)
                if key_of(base + chunk + 32 * w + 31) != trail]
        w_end = ends[0] if trail >= 0 and trail != lead and ends else -1
        length = lambda r: int(indptr[r + 1] - indptr[r])
        if lead_short:
            assert length(lead) <= limit
        if w_end >= 0:
            assert length(trail) <= limit
            assert int(indptr[trail + 1]) <= base + chunk + 32 * (w_end + 1)
        lead_s, lead_t = (int(indptr[lead]), int(indptr[lead + 1])) \
            if lead >= 0 and not lead_short else (0, 0)
        trail_s, trail_t = (int(indptr[trail]), int(indptr[trail + 1])) \
            if trail >= 0 and w_end < 0 else (0, 0)
        lead_hub = lead >= 0 and not lead_short and lead_t - lead_s > limit
        trail_hub = trail >= 0 and w_end < 0 and trail_t - trail_s > limit
        # empty rows: -inf between each key in [first, last] and the one
        # before it
        for pos in range(max(base, first), min(base + chunk, last + 1)):
            prev = key_of(pos - 1)
            assert prev <= key_of(pos)
            for r in range(prev + 1, key_of(pos)):
                store(r, ninf)
        # rows closed inside the chunk, in edge order
        lo = max(base, first)
        hi = min(base + chunk, last)
        pos = lo
        while pos < hi:
            r = keys[pos - base]
            end = pos
            while end < hi and keys[end - base] == r:
                end += 1
            runs_past = end == base + chunk and r == trail
            vals = fold(logits[pos:end], ninf)
            if not runs_past:
                if r != lead:
                    assert pos == int(indptr[r]) and end == int(indptr[r + 1])
                    store(r, vals)
                elif lead_hub:
                    put(k, 0, vals)
            else:
                carry = vals
            pos = end
        if trail_hub:
            put(k, 0 if trail == lead or trail_s == lo else 1, carry)
        elif trail >= 0 and trail != lead:     # the owner reads on
            if w_end >= 0:                     # windows 0 .. w_end
                ahead = [key_of(p) for p in range(
                    base + chunk, base + chunk + 32 * (w_end + 1))]
                rows = [base + chunk + i for i, r in enumerate(ahead)
                        if r == trail]
                assert rows == list(range(base + chunk, base + chunk
                                          + len(rows)))
            else:
                assert trail_s >= lo
                assert trail_t - (base + chunk) < limit and trail_t <= last
                rows = range(base + chunk, trail_t)
            store(trail, nan_max(carry, fold(logits[list(rows)], ninf)))
        if lead_hub:
            arrive(lead, lead_s, lead_t)
        if trail_hub and trail != lead:
            arrive(trail, trail_s, trail_t)
    np.testing.assert_array_equal(written, 1)     # every row exactly once
    assert not arrivals.any()
    return out


def layout(counts, lead=0, cut=0):
    """(dst, indptr) for per-row counts, with ``lead`` edges before
    indptr[0] and ``cut`` after indptr[-1] that belong to no row (their dst
    is row 0 and the last row, as a graph's padding edges are)."""
    counts = np.asarray(counts, np.int64)
    dst = np.concatenate([np.zeros(lead, np.int64),
                          np.repeat(np.arange(len(counts)), counts),
                          np.full(cut, max(len(counts) - 1, 0))])
    indptr = lead + np.concatenate([[0], np.cumsum(counts)])
    return dst.astype(np.int32), indptr.astype(np.int32)


def check(counts, h, chunk=SEGMENT_MAX_CHUNK, limit=SEGMENT_MAX_LIMIT,
          lead=0, cut=0, seed=0, nan=False):
    dst, indptr = layout(counts, lead, cut)
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(len(dst), h)).astype(np.float32)
    logits[rng.random(len(dst)) < 0.2] = -np.inf
    nonempty = np.flatnonzero(np.asarray(counts))
    if len(nonempty):          # a row of only -inf
        r = nonempty[0]
        logits[indptr[r]:indptr[r + 1]] = -np.inf
    if nan and len(dst):
        logits[rng.integers(0, len(dst), 3), rng.integers(0, h, 3)] = np.nan
    n_rows = len(counts)
    got = model_segment_max(logits, dst, indptr, n_rows, chunk, limit, seed)
    # the plain version over the rows' edges only
    a, b = int(indptr[0]), int(indptr[-1])
    want = segment_max_reference(torch.from_numpy(logits[a:b]),
                                 torch.from_numpy(dst[a:b]), None,
                                 n_rows).numpy()
    np.testing.assert_array_equal(got, want)
    return got


def tight_layouts(c, limit):
    """Rows of exactly C and C+1 edges and of L and L+1, a hub of many
    pieces, empty first and last rows, runs of empty rows across a chunk
    boundary."""
    return {
        "bounds": [0, c, c + 1, 0, 0, limit, limit + 1, 1, c - 1, 0, 2,
                   limit - 1, 0],
        "hub": [0, 3, 9 * c + 17, 1, 0, 0, 5, 4 * limit, 0],
        "empty_runs": [0] * 5 + [c - 3] + [0] * 40 + [7] + [0] * 9,
        "single_row": [5 * c + 3],
        "no_edges": [0] * 30,
    }


@pytest.mark.parametrize("h", [1, 4, 5, 40])
@pytest.mark.parametrize("name", ["bounds", "hub", "empty_runs",
                                  "single_row", "no_edges"])
def test_model_on_tight_layouts(name, h):
    """The kernel's own chunk and limit, at the layouts where its rules
    are tight, also with edges before indptr[0] and after indptr[-1]."""
    counts = tight_layouts(SEGMENT_MAX_CHUNK, SEGMENT_MAX_LIMIT)[name]
    check(counts, h, seed=h, nan=h == 5)
    check(counts, h, lead=SEGMENT_MAX_CHUNK + 3, cut=50, seed=h + 1)


@pytest.mark.parametrize("chunk", [SEGMENT_MAX_CHUNK])
def test_model_at_each_chunk_the_launcher_takes(chunk):
    for name, counts in tight_layouts(chunk, SEGMENT_MAX_LIMIT).items():
        check(counts, 4, chunk=chunk, lead=7, cut=3, seed=chunk, nan=True)


def test_model_nan_wins_and_all_neginf_rows():
    got = check([0, 3, 0, 300, 2, 0], 4, seed=3, nan=True)
    assert np.isnan(got).sum() >= 1
    assert np.isneginf(got[1]).all() and np.isneginf(got[[0, 2, 5]]).all()


def test_schedule_from_the_shape():
    s = segment_max_schedule(87040, 4)
    assert (s.n_chunks, s.partials_shape) == (681, (681, 2, 4))
    assert segment_max_schedule(0, 5).n_chunks == 1     # the end sentinel
    assert segment_max_schedule(256, 1).n_chunks == 3
    # the kernel's rule: the limit is the chunk plus 1 to 32 windows of 32
    assert (SEGMENT_MAX_LIMIT - SEGMENT_MAX_CHUNK) % 32 == 0
    assert 32 <= SEGMENT_MAX_LIMIT - SEGMENT_MAX_CHUNK <= 1024


@pytest.mark.parametrize("name,value", [("kC", SEGMENT_MAX_CHUNK),
                                        ("kL", SEGMENT_MAX_LIMIT)])
def test_wrapper_constants_are_the_kernels(name, value):
    """The wrapper's chunk and limit (the schedule's and the scratch's)
    are the constants the kernel is compiled with."""
    src = (Path(__file__).resolve().parents[1] / "kgc_gcn_torch" / "csrc"
           / "segment_max.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (.+?);", src))
    assert consts["kPer"] == "4" and consts["kC"] == "32 * kPer"
    got = 32 * int(consts["kPer"]) if name == "kC" else int(consts[name])
    assert got == value


@settings(max_examples=60, deadline=None, database=None)
@given(counts=st.lists(st.one_of(st.integers(0, 3), st.integers(0, 40)),
                       min_size=1, max_size=60),
       chunk=st.sampled_from([1, 2, 3, 8, 16, 64]),
       extra=st.sampled_from([0, 32, 96]),
       h=st.sampled_from([1, 4, 5]),
       lead=st.integers(0, 9), cut=st.integers(0, 9),
       seed=st.integers(0, 2**16))
def test_model_matches_plain_on_random_layouts(counts, chunk, extra, h, lead,
                                               cut, seed):
    """The rules cover every row once at any chunk and limit of the model,
    on random layouts: empty rows and runs of them, rows on chunk
    boundaries, hubs of many pieces, edges outside [indptr[0],
    indptr[-1])."""
    check(counts, h, chunk=chunk, limit=chunk + 32 + extra, lead=lead,
          cut=cut, seed=seed, nan=seed % 5 == 0)
