"""The port's sparse-label BCE, fused score + BCE and dense BCE against the
JAX package's (kgc_gcn_torch/ops/{fused_loss,losses}.py), loss and gradients,
and the plain versions of kernels K2a / K2b against a float64 BCE.

On the CPU ``dense_loss`` / ``dense_grads`` run their plain versions; the
JAX fused path runs its Pallas kernels in interpret mode, as
tests/test_fused_loss.py does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgc_gcn_tpu.data.batching import build_labels as jax_build_labels
from kgc_gcn_tpu.ops import fused_loss as jfl
from kgc_gcn_tpu.ops.losses import bce_with_logits as jax_bce

from kgc_gcn_torch.data.batching import build_labels
from kgc_gcn_torch.ops import fused_loss as pfl
from kgc_gcn_torch.ops.losses import bce_with_logits

# float32 sums over N or B in another order than XLA's: the loss is a mean
# of order-1 terms, the gradients are sums of at most B*L or N terms of
# size ~1/(B*N)
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_TOL = dict(rtol=1e-4, atol=1e-8)


def problem(seed, b=6, n=37, lw=4, d=16, masked=(5,)):
    """h (B, d), ent (N, d), bias (N,), unique label ids padded with N, and
    a row mask with the ``masked`` rows at 0, as numpy."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(b, d)).astype(np.float32)
    ent = rng.normal(size=(n, d)).astype(np.float32)
    bias = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    label_idx = np.full((b, lw), n, np.int32)
    for i in range(b):
        k = rng.integers(1, lw + 1)
        label_idx[i, :k] = rng.choice(n, size=k, replace=False)
    mask = np.ones((b,), np.float32)
    mask[list(masked)] = 0.0
    return h, ent, bias, label_idx, mask


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got)
                                          else got),
                               np.asarray(want), err_msg=name, **tol)


@pytest.mark.parametrize("smooth", [0.0, 0.1])
@pytest.mark.parametrize("masked", [(), (5,)])
def test_sparse_bce_matches_jax(smooth, masked):
    h, ent, bias, label_idx, mask = problem(0, masked=masked)
    logits = (h @ ent.T + bias).astype(np.float32)
    want, want_g = jax.value_and_grad(
        lambda x: jfl.sparse_bce_with_logits(x, jnp.asarray(label_idx), smooth,
                                             jnp.asarray(mask)))(
        jnp.asarray(logits))
    x = _t(logits, grad=True)
    got = pfl.sparse_bce_with_logits(x, _t(label_idx), smooth, _t(mask))
    (got_g,) = torch.autograd.grad(got, x)
    _close(got, want, LOSS_TOL, "loss")
    _close(got_g, want_g, GRAD_TOL, "d_logits")


@pytest.mark.parametrize("smooth", [0.0, 0.1])
@pytest.mark.parametrize("n", [37, 600])   # below one JAX tile; two ragged tiles
def test_fused_score_bce_matches_jax(smooth, n):
    h, ent, bias, label_idx, mask = problem(1, n=n)

    def jax_loss(h_, e_, b_):
        return jfl.fused_score_bce(h_, e_, b_, jnp.asarray(label_idx), smooth,
                                   jnp.asarray(mask), interpret=True)

    want, want_g = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(h), jnp.asarray(ent), jnp.asarray(bias))
    args = [_t(a, grad=True) for a in (h, ent, bias)]
    got = pfl.fused_score_bce(*args, _t(label_idx), smooth, _t(mask))
    got_g = torch.autograd.grad(got, args)
    _close(got, want, LOSS_TOL, "loss")
    for a, b_, name in zip(got_g, want_g, ("d_h", "d_ent", "d_bias")):
        _close(a, b_, GRAD_TOL, name)


@pytest.mark.parametrize("smooth", [0.0, 0.1])
def test_dense_bce_matches_jax(smooth):
    h, ent, bias, label_idx, mask = problem(2)
    logits = (h @ ent.T + bias).astype(np.float32)
    lbl = build_labels(_t(label_idx), ent.shape[0], smooth)
    want_lbl = jax_build_labels(jnp.asarray(label_idx), ent.shape[0], smooth)
    _close(lbl, want_lbl, dict(rtol=0, atol=0), "labels")
    want, want_g = jax.value_and_grad(
        lambda x: jax_bce(x, want_lbl, jnp.asarray(mask)))(jnp.asarray(logits))
    x = _t(logits, grad=True)
    got = bce_with_logits(x, lbl, _t(mask))
    (got_g,) = torch.autograd.grad(got, x)
    _close(got, want, LOSS_TOL, "loss")
    _close(got_g, want_g, GRAD_TOL, "d_logits")


def test_fused_equals_sparse_equals_dense_in_torch():
    """The three loss forms are one function: fused (through the plain
    K2a/K2b), sparse and dense agree in value and in the gradients."""
    h, ent, bias, label_idx, mask = problem(3, n=50)
    args = [_t(a, grad=True) for a in (h, ent, bias)]
    logits = args[0] @ args[1].T + args[2]
    lbl = build_labels(_t(label_idx), 50, 0.1)
    losses = [pfl.fused_score_bce(*args, _t(label_idx), 0.1, _t(mask)),
              pfl.sparse_bce_with_logits(logits, _t(label_idx), 0.1, _t(mask)),
              bce_with_logits(logits, lbl, _t(mask))]
    grads = [torch.autograd.grad(loss, args, retain_graph=True)
             for loss in losses]
    for loss, g in zip(losses[1:], grads[1:]):
        _close(loss, losses[0].detach(), LOSS_TOL)
        for a, b_ in zip(g, grads[0]):
            _close(a, b_, GRAD_TOL)


@pytest.mark.parametrize("base", [0.0, 1 / 37])
def test_plain_k2_against_float64_bce(base):
    """dense_loss_reference / dense_grads_reference (the plain K2a / K2b)
    against the same sums in float64, with a masked row."""
    h, ent, bias, _, mask = problem(4, b=5, n=37, d=9, masked=(1, 3))
    g = 0.37
    loss = pfl.dense_loss(_t(h), _t(ent), _t(bias), _t(mask), base)
    d_h, d_ent, d_bias = pfl.dense_grads(torch.tensor(g), _t(h), _t(ent),
                                         _t(bias), _t(mask), base)
    s = h.astype(np.float64) @ ent.astype(np.float64).T + bias
    w = mask.astype(np.float64)[:, None]
    want = np.sum(w * (np.maximum(s, 0) - base * s + np.log1p(np.exp(-np.abs(s)))))
    dl = (1 / (1 + np.exp(-s)) - base) * w * g
    _close(loss, want, dict(rtol=1e-6, atol=0))
    for got, w_, name in ((d_h, dl @ ent, "d_h"), (d_ent, dl.T @ h, "d_ent"),
                          (d_bias, dl.sum(0), "d_bias")):
        _close(got, w_, dict(rtol=1e-5, atol=1e-6), name)
    assert d_h[1].abs().max() == 0 and d_h[3].abs().max() == 0


def test_k2_wrappers_check_their_inputs():
    h, ent, bias, _, mask = problem(5)
    with pytest.raises(ValueError, match="float32"):
        pfl.dense_loss(_t(h).double(), _t(ent), _t(bias), _t(mask), 0.0)
    with pytest.raises(ValueError, match="disagree"):
        pfl.dense_grads(torch.tensor(1.0), _t(h)[:, :3], _t(ent), _t(bias),
                        _t(mask), 0.0)
    before = (pfl.dense_loss.launches, pfl.dense_grads.launches)
    pfl.dense_loss(_t(h), _t(ent), _t(bias), _t(mask), 0.0)
    assert (pfl.dense_loss.launches, pfl.dense_grads.launches) == before


@pytest.mark.parametrize("b,n,d,n_sm", [
    (128, 40943, 200, 132), (128, 14541, 200, 132), (300, 129, 40, 132),
    (7, 300, 300, 132), (3, 65, 1, 132), (64, 19201, 200, 132),
    (130, 700, 301, 4), (5, 1, 249, 1), (9, 50, 496, 132), (2, 640, 8, 10)])
def test_k2b_schedule_covers_every_tile_once(b, n, d, n_sm):
    """K2b's schedule: block runs cover the 64-entity tiles once, in order,
    none empty, at most one block an SM; one d_h partial a block, of
    (B rounded up to the row chunk of 128, ld_partial); windows of at most 248 columns (multiples of 8) that cover d, the
    last one not empty; operands within one block's shared memory."""
    s = pfl.grads_schedule(b, n, d, n_sm)
    assert (s.n_tiles - 1) * 64 < n <= s.n_tiles * 64
    runs = [s.tile_range(x) for x in range(s.blocks)]
    assert [t for run in runs for t in run] == list(range(s.n_tiles))
    assert all(len(run) > 0 for run in runs) and s.blocks <= n_sm
    assert s.scratch_floats == s.blocks * -(-b // 128) * 128 * s.ld_partial
    assert s.window % 8 == 0 and 0 < s.window <= 248
    assert s.ld_partial == s.window * s.n_windows
    assert s.ld_partial - s.window < d <= s.ld_partial
    assert s.smem_bytes <= 232448
