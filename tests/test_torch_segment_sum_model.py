"""A model of kernel K1's two-pass chunk schedule (csrc/segment_sum.cu),
step for step in numpy, held against np.add.at on random CSR layouts drawn
by hypothesis.  It checks the kernel's index rules on the CPU; the CUDA
kernel itself is held against the plain version in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402


def chunked_segment_sum(msg, dst, indptr, chunk):
    """A model of csrc/segment_sum.cu's index arithmetic, step for step:
    pass A walks each chunk of ``chunk`` edges, closes a row where ``dst``
    changes, writes rows that lie inside the chunk to out and the partial
    sums of split rows to carry[k][slot]; pass B, from ``indptr``, writes
    zeros to empty rows and sums split rows' partials in chunk order.  Every
    out row and carry slot must be written exactly once and read only after
    it was written."""
    n_rows, d = len(indptr) - 1, msg.shape[1]
    first, last = int(indptr[0]), int(indptr[n_rows])
    n_chunks = -(-len(msg) // chunk)
    out = np.full((n_rows, d), np.nan)
    carry = np.full((n_chunks, 2, d), np.nan)

    def store(dest, acc):
        assert np.isnan(dest).all()
        dest[:] = acc

    for k in range(n_chunks):                                   # pass A
        c0 = k * chunk
        e0 = max(c0, first)
        end = last if last - c0 <= chunk else c0 + chunk
        if e0 >= end:
            continue
        row = dst[e0]
        starts = e0 == first or dst[e0 - 1] != row
        slot = 0 if e0 == c0 else 1
        acc = np.zeros(d)
        for e in range(e0, end):
            if dst[e] != row:
                assert row < dst[e] < n_rows
                store(out[row] if starts else carry[k, slot], acc)
                acc, row, starts, slot = np.zeros(d), dst[e], True, 1
            acc = acc + msg[e]
        ends = end == last or dst[end] != row
        store(out[row] if starts and ends else carry[k, slot], acc)
    for r in range(n_rows):                                     # pass B
        e0, e1 = int(indptr[r]), int(indptr[r + 1])
        if e0 == e1:
            store(out[r], 0.0)
            continue
        k0, k1 = e0 // chunk, (e1 - 1) // chunk
        if k0 == k1:
            continue
        acc = carry[k0, 0 if e0 == k0 * chunk else 1].copy()
        for k in range(k0 + 1, k1 + 1):
            acc += carry[k, 0]
        assert not np.isnan(acc).any()
        store(out[r], acc)
    return out


@settings(max_examples=60, deadline=None, database=None)
@given(counts=st.lists(st.one_of(st.integers(0, 3), st.integers(0, 80)),
                       min_size=1, max_size=40),
       chunk=st.sampled_from([1, 2, 3, 16, 32, 64]),
       cut=st.integers(0, 5), lead=st.integers(0, 5))
def test_chunk_schedule_model_matches_add_at(counts, chunk, cut, lead):
    """The kernel's chunk, direct / carry and slot rules cover
    every edge once, on random CSR layouts (empty rows, hubs, rows on chunk
    boundaries), also with edges before indptr[0] (``lead``) or after
    indptr[-1] (``cut``) that belong to no row."""
    counts = np.asarray(counts)
    dst = np.repeat(np.arange(len(counts)), counts)
    indptr = lead + np.concatenate([[0], np.cumsum(counts)])
    n_edges = lead + len(dst) + cut
    msg = np.random.default_rng(len(dst)).integers(-8, 9, size=(n_edges, 2))
    want = np.zeros((len(counts), 2))
    np.add.at(want, dst, msg[lead:lead + len(dst)])
    ids = np.concatenate([np.zeros(lead, int), dst,
                          np.full(cut, max(len(counts) - 1, 0))])
    np.testing.assert_array_equal(chunked_segment_sum(msg, ids, indptr, chunk),
                                  want)
