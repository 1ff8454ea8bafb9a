"""A model of kernel K2a's schedule and order of addition
(csrc/fused_score_bce.cu, loss_tiles_kernel and sum_partials_kernel),
step for step in numpy, held against the JAX package's Pallas kernel in
interpret mode and against a float64 sum; and K2a's schedule function
(ops/fused_loss.py:loss_schedule).  The CUDA kernel itself is held
against the plain version in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from kgc_gcn_tpu.ops.fused_loss import _dense_loss_pallas

from kgc_gcn_torch.ops.fused_loss import loss_schedule

ROWS, TILE_N, THREADS = 128, 64, 512   # kChunkRows, kTileN, kLossThreads
MAX_SMEM = 232448                      # one block's shared memory (227 KB)
# a float32 sum of B*N terms in another order (chip_smoke.py's K2_LOSS_RTOL)
K2_LOSS_RTOL = 1e-5


@pytest.mark.parametrize("b,n,d,n_sm", [
    (128, 40943, 200, 132), (128, 14541, 200, 132), (300, 129, 40, 132),
    (3, 65, 1, 132), (130, 700, 301, 4), (9, 50, 496, 132)])
def test_k2a_schedule_covers_every_tile_once(b, n, d, n_sm):
    """Block runs cover the 64-entity tiles once, in order, none empty; the
    row chunks of 128 cover B, one block a (run, chunk), at most one block
    an SM and one partial a block; windows of at
    most 200 columns (multiples of 8) cover d, the last one not empty; h's
    chunk, the entity tile, two score tiles, the row weights and the warp
    sums fit in one block's shared memory."""
    s = loss_schedule(b, n, d, n_sm)
    assert (s.n_tiles - 1) * TILE_N < n <= s.n_tiles * TILE_N
    runs = [s.tile_range(x) for x in range(s.blocks)]
    assert [t for run in runs for t in run] == list(range(s.n_tiles))
    assert all(len(run) > 0 for run in runs)
    assert (s.row_chunks - 1) * ROWS < b <= s.row_chunks * ROWS
    assert s.partials == s.blocks * s.row_chunks <= n_sm
    assert s.window % 8 == 0 and 0 < s.window <= 200
    assert s.window * (s.n_windows - 1) < d <= s.window * s.n_windows
    assert s.smem_bytes == (16 * (s.window // 4) * (132 + 68)
                            + 4 * (2 * 128 * 66 + 128 + 16))
    assert s.smem_bytes <= MAX_SMEM


def test_k2a_schedule_at_the_presets_shapes():
    """WN18RR: 128 blocks of 5 tiles; FB15k-237: 114 blocks of 2; d 200 in
    one window (h's chunk resident)."""
    for n, blocks, run in ((40943, 128, 5), (14541, 114, 2)):
        s = loss_schedule(128, n, 200, 132)
        assert (s.blocks, s.tiles_per_block, s.n_windows, s.window) == (
            blocks, run, 1, 200)
    assert loss_schedule(128, 40943, 200, 132).n_windows == 1
    assert loss_schedule(128, 40943, 201, 132).n_windows == 2


def k2a_model(h, ent, bias, w, base, n_sm):
    """K2a as the kernel adds it, in float32: block (x, y) takes its tiles
    and row chunk y; the producer warps (threads 0-255) score each
    tile over the whole depth, window after window, over zero-filled
    operands, and add nothing themselves; epilogue thread q (index 256 + q)
    owns entity q % 64 and rows 32 (q // 64) + m of every tile and adds
    w * term to its running sum, tile after tile, m in order, dropping rows
    past B and entities past N by a select.  Each warp's sums are added by
    the xor butterfly, the 16 warp sums in warp order, then the blocks'
    partials in the order y * blocks + x."""
    b, d = h.shape
    n = ent.shape[0]
    s = loss_schedule(b, n, d, n_sm)
    cols = s.window * s.n_windows
    hp = np.zeros((s.row_chunks * ROWS, cols), np.float32)
    hp[:b, :d] = h
    ep = np.zeros((s.n_tiles * TILE_N, cols), np.float32)
    ep[:n, :d] = ent
    bp = np.zeros(s.n_tiles * TILE_N, np.float32)
    bp[:n] = bias
    wp = np.zeros(s.row_chunks * ROWS, np.float32)
    wp[:b] = w
    base = np.float32(base)
    partials = []
    for c in range(s.row_chunks):
        r = slice(c * ROWS, (c + 1) * ROWS)
        row_ok = (np.arange(ROWS) + c * ROWS < b).reshape(4, 32)
        wr = wp[r].reshape(4, 32)
        for x in range(s.blocks):
            sums = np.zeros((THREADS // 32, 32), np.float32)  # [warp, lane]
            q_sums = np.zeros((4, TILE_N), np.float32)    # [q // 64, q % 64]
            for t in s.tile_range(x):
                e = slice(t * TILE_N, (t + 1) * TILE_N)
                acc = np.zeros((ROWS, TILE_N), np.float32)
                for win in range(s.n_windows):
                    k = slice(win * s.window, (win + 1) * s.window)
                    acc += hp[r, k] @ ep[e, k].T
                sc = acc + bp[e]
                term = (np.maximum(sc, 0) - base * sc
                        + np.log1p(np.exp(-np.abs(sc)))).reshape(4, 32, 64)
                ok = np.arange(TILE_N) + t * TILE_N < n
                for m in range(32):
                    keep = row_ok[:, m, None] & ok[None, :]
                    q_sums += np.where(keep, wr[:, m, None] * term[:, m, :],
                                       np.float32(0))
            sums[8:] = q_sums.reshape(8, 32)
            lane = np.arange(32)
            v = sums
            for off in (16, 8, 4, 2, 1):
                v = v + v[:, lane ^ off]
            part = v[0, 0]
            for warp in range(1, THREADS // 32):
                part = np.float32(part + v[warp, 0])
            partials.append(part)
    total = np.float32(0)
    for p in partials:
        total = np.float32(total + p)
    return total


@pytest.mark.parametrize("b,n,d,masked,n_sm", [
    (6, 37, 16, (5,), 132),            # N below one tile
    (130, 200, 24, (0, 129), 2),       # two row chunks, runs of two tiles
    (40, 300, 12, (3,), 1),            # a run of five tiles
    (9, 129, 496, (4,), 2),            # three column windows, a ragged tile
    (3, 65, 1, (1,), 132),             # N one past a tile multiple, d 1
])
def test_k2a_model_matches_jax_and_float64(b, n, d, masked, n_sm):
    rng = np.random.default_rng(b * n + d)
    h = rng.normal(size=(b, d)).astype(np.float32)
    ent = rng.normal(size=(n, d)).astype(np.float32)
    bias = (rng.normal(size=n) * 0.1).astype(np.float32)
    w = np.ones(b, np.float32)
    w[list(masked)] = 0.0
    base = 1.0 / n
    got = k2a_model(h, ent, bias, w, base, n_sm)
    s = h.astype(np.float64) @ ent.astype(np.float64).T + bias
    want64 = np.sum(w[:, None] * (np.maximum(s, 0) - base * s
                                  + np.log1p(np.exp(-np.abs(s)))))
    want_jax = float(_dense_loss_pallas(jnp.asarray(h), jnp.asarray(ent),
                                        jnp.asarray(bias), jnp.asarray(w),
                                        base, True))
    np.testing.assert_allclose(got, want64, rtol=K2_LOSS_RTOL, atol=0)
    np.testing.assert_allclose(got, want_jax, rtol=K2_LOSS_RTOL, atol=0)
