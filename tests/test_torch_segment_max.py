"""Kernel K5, the sorted CSR segment-max (kgc_gcn_torch/ops/segment_max.py),
the attention wrappers over K1 (K6, kgc_gcn_torch/ops/sorted_ops.py) and the
RGAT segment softmax built on both (kgc_gcn_torch/models/rgat.py), on the CPU,
against the JAX package.

  * K5's plain version against the TPU kernel in interpret mode
    (``spmm_pallas.py:segment_max_sorted``) and ``jax.ops.segment_max``:
    exact, since a max is exact in any order.
  * Each K6 function's forward and VJP against its JAX counterpart: 1e-4
    against the custom VJPs over the interpret-mode kernels (their one-hot
    products split float32 into hi/lo bf16 parts), 1e-5 against plain JAX
    autodiff (float32 sums in another order); the absolute part is relative
    to the largest element.
  * ``segment_softmax`` against both JAX paths, with a masked row and empty
    rows: values, finite gradients, rows summing to 1.

The CUDA kernel is held against the plain version in tests/test_torch_cuda.py
on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgc_gcn_tpu.models.rgat import segment_softmax as jax_segment_softmax
from kgc_gcn_tpu.ops import spmm_pallas as sp

from kgc_gcn_torch.models.rgat import segment_softmax
from kgc_gcn_torch.ops.kernels import KERNELS, PLAIN
from kgc_gcn_torch.ops.segment_max import segment_max
from kgc_gcn_torch.ops.segment_sum import segment_sum
from kgc_gcn_torch.ops.sorted_ops import (
    edge_compose, gather_rows_few, gather_rows_sorted, segment_sum_sorted)
from test_torch_common import port_toy
from test_torch_cuda import max_case, max_cases

KERNEL_RTOL = 1e-4
XLA_RTOL = 1e-5


def close(got, want, rtol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("case", ["empty_rows", "hub_h1", "hub_h5"])
def test_plain_matches_pallas_and_jax_segment_max(case):
    counts, h = max_cases()[case]
    n_rows = len(counts)
    logits, dst, indptr = max_case(counts, h, seed=1)
    args = (jnp.asarray(logits), jnp.asarray(dst))
    want_pallas = np.asarray(sp.segment_max_sorted(
        *args, jnp.asarray(indptr), n_rows, interpret=True))
    want_xla = np.asarray(jax.ops.segment_max(*args, num_segments=n_rows,
                                              indices_are_sorted=True))
    before = segment_max.launches
    got = segment_max(*(torch.from_numpy(a) for a in (logits, dst, indptr)),
                      n_rows)
    assert segment_max.launches == before        # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == (n_rows, h)
    got = got.numpy()
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got, want_pallas)
    empty = np.asarray(counts) == 0
    assert empty.any() or case != "empty_rows"
    assert np.all(got[empty] == -np.inf)             # empty rows are -inf
    assert np.isneginf(got).all(axis=1).any()       # the all -inf row


def test_wrapper_rejects_bad_inputs():
    logits, dst, indptr = max_case([1, 0, 2, 1], 3, seed=2)
    t = lambda a: torch.from_numpy(a)
    for dtype in (torch.float64, torch.bfloat16):
        with pytest.raises(ValueError, match="float32"):
            segment_max(t(logits).to(dtype), t(dst), t(indptr), 4)
    with pytest.raises(ValueError, match="dst"):
        segment_max(t(logits), t(dst).long(), t(indptr), 4)
    with pytest.raises(ValueError, match="indptr"):
        segment_max(t(logits), t(dst), t(indptr), 5)
    bad = indptr.copy()
    bad[-1] = len(dst) + 1
    with pytest.raises(ValueError, match="edge count"):
        segment_max(t(logits), t(dst), t(bad), 4)


# ------------------------------------------------------------------ K6

def _k6_case(toy, name: str):
    """(JAX function of the differentiable inputs on the kernel path, the
    same through plain JAX ops, the port's function, the inputs) for one K6
    wrapper on the toy graph's out half (it holds the padding edges)."""
    _, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    jh, ph = jgraph.outb, pgraph.outb
    n, n_rel2 = jgraph.n_ent, 2 * jgraph.n_rel
    e = int(jh.src.shape[0])
    n_seg = int(jh.r_indptr.shape[0]) - 1
    rng = np.random.default_rng(3)
    draw = lambda *s: rng.normal(size=s).astype(np.float32)
    rdata = (jh.rperm, jh.r_indptr, jh.r_rel)
    prdata = (ph.rperm, ph.r_indptr, ph.r_rel)
    if name == "edge_compose":
        return (lambda h, r: sp.edge_compose(h, r, jh.src, jh.rel, jh.sperm,
                                             jh.s_indptr, jh.s_src, rdata, n,
                                             True),
                lambda h, r: h[jh.src] * r[jh.rel],
                lambda h, r: edge_compose(h, r, ph),
                (draw(n, 16), draw(n_rel2, 16)))
    if name == "segment_sum_sorted":
        return (lambda v: sp.segment_sum_sorted(v, jh.dst, jh.indptr, n, True),
                lambda v: jax.ops.segment_sum(v, jh.dst, num_segments=n),
                lambda v: segment_sum_sorted(v, ph.dst, ph.indptr, n),
                (draw(e, 4),))
    if name == "gather_rows_sorted":
        return (lambda t: sp.gather_rows_sorted(t, jh.dst, jh.indptr, n, True),
                lambda t: t[jh.dst],
                lambda t: gather_rows_sorted(t, ph.dst, ph.indptr, n),
                (draw(n, 4),))
    return (lambda t: sp.gather_rows_few(t, jh.rel, n_seg, rdata, True),
            lambda t: t[jh.rel],
            lambda t: gather_rows_few(t, ph.rel, n_seg, prdata),
            (draw(n_rel2, 4),))


@pytest.mark.parametrize("reference", ["pallas_interpret", "autodiff"])
@pytest.mark.parametrize("name", ["edge_compose", "segment_sum_sorted",
                                  "gather_rows_sorted", "gather_rows_few"])
def test_k6_forward_and_vjp_match_jax(toy, name, reference):
    kernel_fn, plain_fn, port_fn, inputs = _k6_case(toy, name)
    jfn = kernel_fn if reference == "pallas_interpret" else plain_fn
    tol = KERNEL_RTOL if reference == "pallas_interpret" else XLA_RTOL
    want, vjp = jax.vjp(jfn, *map(jnp.asarray, inputs))
    g = np.random.default_rng(4).normal(size=want.shape).astype(np.float32)
    want_grads = vjp(jnp.asarray(g))

    args = [torch.from_numpy(a).requires_grad_() for a in inputs]
    before = segment_sum.launches
    got = port_fn(*args)
    got.backward(torch.from_numpy(g))
    assert segment_sum.launches == before        # plain versions on the CPU
    close(got.detach(), want, tol, f"{name} forward")
    for i, (a, w) in enumerate(zip(args, want_grads)):
        close(a.grad, w, tol, f"{name} grad {i}")


# ---------------------------------------------------------- segment softmax

def _softmax_case():
    """Logits over 9 segments: empty first, inner and last segments, one
    segment of only -inf logits, and about a quarter of the edges at -inf."""
    rng = np.random.default_rng(5)
    counts = np.array([0, 3, 5, 0, 4, 2, 7, 1, 0])
    seg = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    logits = rng.normal(size=(len(seg), 3)).astype(np.float32)
    logits[rng.random(len(seg)) < 0.25] = -np.inf
    logits[indptr[5]:indptr[6]] = -np.inf
    return logits, seg, indptr, len(counts)


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["pallas_interpret", "xla"])
def test_segment_softmax_matches_jax(use_pallas):
    logits, seg, indptr, n_seg = _softmax_case()
    w = np.random.default_rng(6).normal(size=logits.shape).astype(np.float32)

    def f(x):
        alpha = jax_segment_softmax(x, jnp.asarray(seg), n_seg,
                                    indptr=jnp.asarray(indptr),
                                    use_pallas=use_pallas,
                                    interpret=use_pallas)
        return jnp.sum(alpha * w), alpha
    (_, want), want_g = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(logits))

    x = torch.from_numpy(logits).requires_grad_()
    t = lambda a: torch.from_numpy(a)
    got = segment_softmax(x, t(seg), t(indptr), n_seg, KERNELS)
    (got * t(w)).sum().backward()
    tol = KERNEL_RTOL if use_pallas else XLA_RTOL
    close(got.detach(), want, tol, "alpha")
    close(x.grad, want_g, tol, "d_logits")
    assert torch.isfinite(got).all() and torch.isfinite(x.grad).all()
    masked = np.isneginf(logits)
    assert not got.detach().numpy()[masked].any()
    assert not x.grad.numpy()[masked].any()
    sums = np.zeros((n_seg, 3))
    np.add.at(sums, seg, got.detach().numpy())
    live = np.zeros((n_seg, 3), bool)
    np.logical_or.at(live, seg, ~masked)
    np.testing.assert_allclose(sums[live], 1.0, rtol=1e-6)
    assert not sums[~live].any()        # empty and all -inf segments
    # the plain bundle gives the same softmax on the CPU
    torch.testing.assert_close(
        segment_softmax(x.detach(), t(seg), t(indptr), n_seg, PLAIN),
        got.detach(), rtol=0, atol=0)
