"""A model of kernel K8's span schedule (csrc/basis_rgcn.cu,
basis_bwd_kernel), step for step in numpy, held against the plain
contractions on random dst-sorted layouts drawn by hypothesis.  It checks
the kernel's index rules on the CPU: spans of fixed length cut into runs by
a ballot of the edges where dst changes, the run starts placed by popcounts,
tiles of 4 (d_msg) and 2 (d_a) edges clamped to the span, and shared memory
that holds NaN wherever the kernel leaves it unwritten.  The CUDA kernel
itself is held against the plain version in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402


def span_runs(dst, e0, n, span):
    """Run starts of one span as the kernel places them: warp w's ballot of
    the heads (t < n and t == 0 or dst changes), a head's index the popcount
    of the lower lanes plus the earlier warps' popcounts; then the end, n."""
    heads = [t < n and (t == 0 or dst[e0 + t] != dst[e0 + t - 1])
             for t in range(span)]
    ballots = [sum(1 << lane for lane in range(32)
                   if 32 * w + lane < span and heads[32 * w + lane])
               for w in range(-(-span // 32))]
    n_runs = sum(bin(b).count("1") for b in ballots)
    starts = np.full(n_runs + 1, -1)
    for t in range(span):
        if heads[t]:
            w, lane = divmod(t, 32)
            idx = bin(ballots[w] & ((1 << lane) - 1)).count("1")
            idx += sum(bin(ballots[v]).count("1") for v in range(w))
            assert starts[idx] == -1
            starts[idx] = t
    starts[n_runs] = n
    return starts


def span_backward(g, msg, a, dst, span):
    """d_msg, d_a as the kernel computes them, with a record of every
    (span, run) an edge landed in and every row of g that was read."""
    e, d = msg.shape
    nb = a.shape[1]
    d_msg, d_a = np.full((e, d), np.nan), np.full((e, nb), np.nan)
    landed = np.zeros(e, int)
    rows_read = []
    for e0 in range(0, e, span):
        n = min(span, e - e0)
        m_s = np.full((span, d), np.nan)          # rows past n: unwritten
        a_s = np.full((span, nb), np.nan)
        m_s[:n], a_s[:n] = msg[e0:e0 + n], a[e0:e0 + n]
        starts = span_runs(dst, e0, n, span)
        assert starts[0] == 0 and (np.diff(starts) > 0).all()
        for t0, t1 in zip(starts[:-1], starts[1:]):
            k, row = t1 - t0, dst[e0 + t0]
            assert (dst[e0 + t0:e0 + t1] == row).all()
            landed[e0 + t0:e0 + t1] += 1
            rows_read.append(row)
            sel = g[row].reshape(nb, d)
            for et in range(-(-k // 4)):          # d_msg tiles of 4 edges
                ti = np.minimum(t0 + 4 * et + np.arange(4), span - 1)
                acc = a_s[ti] @ sel
                for i in range(min(4, k - 4 * et)):
                    assert np.isnan(d_msg[e0 + ti[i]]).all()
                    d_msg[e0 + ti[i]] = acc[i]
            for ep in range(-(-k // 2)):          # d_a tiles of 2 edges
                ti = np.minimum(t0 + 2 * ep + np.arange(2), span - 1)
                acc = m_s[ti] @ sel.T
                for i in range(min(2, k - 2 * ep)):
                    assert np.isnan(d_a[e0 + ti[i]]).all()
                    d_a[e0 + ti[i]] = acc[i]
    return d_msg, d_a, landed, rows_read


@settings(max_examples=60, deadline=None, database=None)
@given(counts=st.lists(st.one_of(st.integers(0, 3), st.integers(0, 150)),
                       min_size=1, max_size=30),
       span=st.sampled_from([1, 2, 3, 4, 5, 32, 64]),
       d=st.integers(1, 6), nb=st.integers(1, 5))
def test_span_schedule_model_matches_plain(counts, span, d, nb):
    """Every edge lands in exactly one (span, run) whose row is its dst;
    rows without edges are never read; g rows read <= spans + non-empty
    rows; every output is written once and equals the plain contractions
    (small integers: exact in any order)."""
    counts = np.asarray(counts)
    dst = np.repeat(np.arange(len(counts)), counts)
    rng = np.random.default_rng(len(dst) * 7 + d)
    msg = rng.integers(-4, 5, size=(len(dst), d)).astype(float)
    a = rng.integers(-4, 5, size=(len(dst), nb)).astype(float)
    g = rng.integers(-4, 5, size=(len(counts), nb * d)).astype(float)
    d_msg, d_a, landed, rows_read = span_backward(g, msg, a, dst, span)
    assert (landed == 1).all()
    assert set(rows_read) <= set(np.flatnonzero(counts))
    n_spans = -(-len(dst) // span)
    assert len(rows_read) <= n_spans + np.count_nonzero(counts)
    sel = g[dst].reshape(len(dst), nb, d)
    np.testing.assert_array_equal(d_msg, np.einsum("ebd,eb->ed", sel, a))
    np.testing.assert_array_equal(d_a, np.einsum("ebd,ed->eb", sel, msg))
