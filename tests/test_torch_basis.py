"""K7 and K8 of the port, through their plain versions, against the JAX
package's basis kernels (kgc_gcn_torch/ops/basis.py vs
kgc_gcn_tpu/ops/spmm_pallas.py: _basis_fused_call, the einsum backward,
basis_aggregate_fused with and without its backward plan).

Inputs are numpy draws from fixed seeds on the ``toy`` graph (d = 8, B = 3).
Tolerances: rtol = atol = 1e-4 against the Pallas kernels in interpret mode,
whose hi/lo bf16 split gives near-float32 products (as tests/test_pallas.py
holds them); 1e-5 against the XLA einsums, float32 sums in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kgc_gcn_tpu.ops.spmm_pallas as sp

from kgc_gcn_torch.ops.basis import (
    basis_aggregate, basis_backward, basis_backward_reference,
    basis_segment_sum, basis_segment_sum_reference)
from kgc_gcn_torch.ops.kernels import KERNELS
from test_torch_common import port_toy

KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
XLA_TOL = dict(rtol=1e-5, atol=1e-5)
D, NB = 8, 3


def _inputs(seed: int, n_ent: int, n_coeff: int):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_ent, D)).astype(np.float32)
    coeff = rng.normal(size=(n_coeff, NB)).astype(np.float32)
    return x, coeff


def _halves(toy):
    """(JAX half, port half) pairs of the toy graph."""
    _, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    return {"in": (jgraph.inb, pgraph.inb), "out": (jgraph.outb, pgraph.outb)}


@pytest.mark.parametrize("which", ["in", "out"])
def test_basis_sum_matches_the_pallas_kernel(toy, which):
    ds, _, _ = toy
    jhalf, phalf = _halves(toy)[which]
    n = ds.num_entity
    x, coeff = _inputs(1, n, 2 * ds.num_relation)
    msg = x[np.asarray(phalf.src)] * np.asarray(phalf.norm)[:, None]
    a = coeff[np.asarray(phalf.rel)]
    want = sp._basis_fused_call(jnp.asarray(msg), jnp.asarray(a), jhalf.dst,
                                jhalf.indptr, n, NB, interpret=True)
    want = np.asarray(want).reshape(n, NB, -1)[:, :, :D]
    got = basis_segment_sum(torch.from_numpy(msg), torch.from_numpy(a),
                            phalf.dst, phalf.indptr, n)
    assert got.shape == (n, NB * D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy().reshape(n, NB, D), want,
                               **KERNEL_TOL)


def test_basis_backward_matches_the_einsum_oracle(toy):
    """Plain K8 against the JAX fallback's contractions
    (spmm_pallas.py:1536-1542)."""
    ds, jgraph, _ = toy
    half = port_toy()[1].inb
    n, e = ds.num_entity, half.src.shape[0]
    rng = np.random.default_rng(2)
    g = rng.normal(size=(n, NB * D)).astype(np.float32)
    msg = rng.normal(size=(e, D)).astype(np.float32)
    a = rng.normal(size=(e, NB)).astype(np.float32)
    gd = jnp.asarray(g)[jgraph.inb.dst].reshape(-1, NB, D)
    want_dm = jnp.einsum("ebd,eb->ed", gd, jnp.asarray(a))
    want_da = jnp.einsum("ebd,ed->eb", gd, jnp.asarray(msg))
    got_dm, got_da = basis_backward(*(torch.from_numpy(t) for t in (g, msg, a)),
                                    half.dst, half.indptr)
    np.testing.assert_allclose(got_dm.numpy(), np.asarray(want_dm), **XLA_TOL)
    np.testing.assert_allclose(got_da.numpy(), np.asarray(want_da), **XLA_TOL)


@pytest.mark.parametrize("plan", [True, False], ids=["band_plan", "no_plan"])
@pytest.mark.parametrize("which", ["in", "out"])
def test_basis_aggregate_value_and_grads_match_jax(toy, monkeypatch, plan,
                                                   which):
    """The autograd function (K7 forward; K8, K1 and the few-segment sum
    backward) against ``basis_aggregate_fused`` in interpret mode, with the
    band backward's plan and with the XLA backward: the value, d_x and
    d_coeff of a weighted sum of the aggregate."""
    import jax
    monkeypatch.setattr(sp, "BASIS_PAD", "slice")
    ds, _, _ = toy
    jhalf, phalf = _halves(toy)[which]
    n = ds.num_entity
    x, coeff = _inputs(3, n, 2 * ds.num_relation)
    w = np.random.default_rng(4).normal(size=(n, NB, D)).astype(np.float32)
    plan_arrays, plan_meta = (sp.build_basis_bwd_plan(jhalf, n) if plan
                              else (None, None))

    def f(xv, cv):
        agg = sp.basis_aggregate_fused(
            xv, cv, jhalf.src, jhalf.dst, jhalf.rel, jhalf.norm, jhalf.indptr,
            jhalf.sperm, jhalf.s_indptr, jhalf.s_src,
            (jhalf.rperm, jhalf.r_indptr, jhalf.r_rel), plan_arrays, n, NB,
            True, plan_meta)
        return jnp.sum(agg * w), agg

    (_, want), (want_dx, want_dc) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(coeff))

    xt = torch.from_numpy(x).requires_grad_()
    ct = torch.from_numpy(coeff).requires_grad_()
    got = basis_aggregate(xt, ct, phalf, n, KERNELS)
    (got.view(n, NB, D) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy().reshape(n, NB, D),
                               np.asarray(want), **KERNEL_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               **KERNEL_TOL)
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(want_dc),
                               **KERNEL_TOL)


def test_wrappers_count_no_launch_on_the_cpu():
    half = port_toy()[1].inb
    e, n = half.src.shape[0], half.indptr.shape[0] - 1
    msg, a = torch.ones(e, D), torch.ones(e, NB)
    before = (basis_segment_sum.launches, basis_backward.launches)
    out = basis_segment_sum(msg, a, half.dst, half.indptr, n)
    torch.testing.assert_close(
        out, basis_segment_sum_reference(msg, a, half.dst, half.indptr, n),
        rtol=0, atol=0)
    got = basis_backward(torch.ones(n, NB * D), msg, a, half.dst, half.indptr)
    for x, y in zip(got, basis_backward_reference(torch.ones(n, NB * D), msg,
                                                  a, half.dst, half.indptr)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert (basis_segment_sum.launches, basis_backward.launches) == before


@pytest.mark.parametrize("bad", ["msg_dtype", "a_rows", "dst_dtype",
                                 "indptr_len", "g_shape"])
def test_wrappers_check_shapes_and_dtypes(bad):
    half = port_toy()[1].inb
    e, n = half.src.shape[0], half.indptr.shape[0] - 1
    msg, a, dst, indptr = torch.ones(e, D), torch.ones(e, NB), half.dst, half.indptr
    g = torch.ones(n, NB * D)
    if bad == "msg_dtype":
        msg = msg.double()
    elif bad == "a_rows":
        a = a[:-1]
    elif bad == "dst_dtype":
        dst = dst.long()
    elif bad == "indptr_len":
        indptr = indptr[:-1]
    else:
        g = g[:, :-1]
    with pytest.raises(ValueError):
        if bad == "g_shape":
            basis_backward(g, msg, a, dst, indptr)
        else:
            basis_segment_sum(msg, a, dst, indptr, n)
