"""MGCN's backward schedules ``bwd_perm`` (models/mgcn.py) against the JAX
package's ``aggregate_half_pallas`` (``spmm_pallas.py:_agg_fwd``,
``_agg_bwd``), whose Pallas kernels run in interpret mode here.

The port runs the ``contrib`` schedule for all three values
(kgc_gcn_torch/ops/scatter.py:_Aggregate).  The JAX package's ``contrib``,
``operands`` and ``fwdw`` each give the port's gradients of one half's
aggregate, and of the whole encoder, at the float32 kernel tolerance (its
one-hot products split each value into bf16 halves).  In the port the
three give the same gradients to the bit; as in the JAX package,
``operands`` and ``fwdw`` run no K4b under ``ew_impl=pallas``, and without
``use_pallas`` the flag has no effect.
"""

import dataclasses


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgc_gcn_tpu.ops.spmm_pallas import aggregate_half_pallas

from kgc_gcn_torch.convert import jax_leaf_names
from kgc_gcn_torch.models import build_model
from kgc_gcn_torch.ops.elementwise import bwd_products_reference
from kgc_gcn_torch.ops.kernels import PLAIN
from kgc_gcn_torch.ops.scatter import aggregate_half
from test_torch_common import (
    jax_and_port_models, jax_leaves, port_cfg, port_toy)

PERMS = ["contrib", "operands", "fwdw"]
# against the JAX kernels (hi/lo bf16 one-hot products, another order)
F32_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(graph, n_ent, n_rel, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return (f(n_ent, d), f(2 * n_rel + 1, d), f(graph.e_pad, d),
            f(n_ent, d))   # x, rel_all, etab, cotangent


def _port_grads(pgraph, half_name, n_ent, arrays):
    x, rel_all, etab, cot = arrays
    args = [torch.from_numpy(a).requires_grad_() for a in (x, rel_all, etab)]
    out = aggregate_half(*args, getattr(pgraph, half_name), n_ent)
    return out.detach(), torch.autograd.grad(
        (out * torch.from_numpy(cot)).sum(), args)


@pytest.mark.parametrize("half_name", ["inb", "outb"])
@pytest.mark.parametrize("bwd_perm", PERMS)
def test_half_gradients_match_jax(toy, bwd_perm, half_name):
    ds, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    n_ent = ds.num_entity
    arrays = _inputs(pgraph, n_ent, ds.num_relation, 8, seed=11)
    x, rel_all, etab, cot = arrays
    jhalf = getattr(jgraph, half_name)

    def jax_fn(x_, r_, e_):
        out = aggregate_half_pallas(x_, r_, e_, jhalf, n_ent, interpret=True,
                                    bwd_perm=bwd_perm)
        return jnp.sum(out * cot), out

    (_, want_out), want_g = jax.value_and_grad(
        jax_fn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(rel_all), jnp.asarray(etab))
    out, got_g = _port_grads(pgraph, half_name, n_ent, arrays)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               err_msg="forward", **F32_TOL)
    for got, want, name in zip(got_g, want_g, ("d_x", "d_rel", "d_etab")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **F32_TOL)


def _schedule_grads(toy_cfg, **fields):
    """The MGCN encoder's gradients (of a sum over its outputs, on the toy
    graph) under the config's fields, and the number of K4b calls it made
    (its plain version, counted)."""
    ds, pgraph, _ = port_toy()
    cfg = port_cfg(toy_cfg).replace(gcn_drop=0.0, conv_drop=0.0, **fields)
    calls = []

    def products(*a):
        calls.append(a[0].shape)
        return bwd_products_reference(*a)

    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=pgraph.e_pad,
                        generator=torch.Generator().manual_seed(4))
    ent, rel = model.encode(pgraph, kernels=dataclasses.replace(
        PLAIN, bwd_products=products))
    (ent.square().sum() + rel.sum()).backward()
    return ({k: p.grad for k, p in model.named_parameters()
             if p.grad is not None}, len(calls))


@pytest.mark.parametrize("ew", [False, True], ids=["plain", "ew_pallas"])
def test_operands_is_bit_equal_and_fwdw_rounds_like_contrib(toy_cfg, ew):
    """The three schedules on one set of weights give the same encoder
    gradients to the bit; with ``ew_impl=pallas`` only ``contrib`` runs
    K4b's products, once a half (``spmm_pallas.py:651-658``)."""
    fields = dict(use_pallas=True, ew_impl="pallas" if ew else "xla")
    grads, k4b = {}, {}
    for p in PERMS:
        grads[p], k4b[p] = _schedule_grads(toy_cfg, bwd_perm=p, **fields)
    assert k4b == {"contrib": 2 if ew else 0, "operands": 0, "fwdw": 0}
    for p in ("operands", "fwdw"):
        assert grads[p].keys() == grads["contrib"].keys()
        for name, g in grads["contrib"].items():
            torch.testing.assert_close(grads[p][name], g, rtol=0, atol=0,
                                       msg=f"{p} {name}")


@pytest.mark.parametrize("bwd_perm", PERMS)
def test_encoder_gradients_match_jax(toy, toy_cfg, bwd_perm):
    """all_ent and the gradient of every encoder parameter of a weighted
    sum of the encoder's outputs, against JAX ``MGCN.encode`` on its
    ``use_pallas`` path (interpret mode) with the same ``bwd_perm``."""
    cfg = toy_cfg.replace(use_pallas=True, bwd_perm=bwd_perm, gcn_drop=0.0,
                          conv_drop=0.0)
    model, params, state, port = jax_and_port_models(toy, cfg, seed=6)
    _, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    rng = np.random.default_rng(8)
    w_ent = rng.normal(size=(jgraph.n_ent, 32)).astype(np.float32)
    w_rel = rng.normal(size=(2 * jgraph.n_rel, 32)).astype(np.float32)

    def f(p):
        ent, rel, _ = model.encode(p, state, jgraph)
        return jnp.sum(ent * w_ent) + jnp.sum(rel * w_rel), ent
    (_, want_ent), grads = jax.value_and_grad(f, has_aux=True)(params)
    ent, rel = port.encode(pgraph)
    ((ent * torch.from_numpy(w_ent)).sum()
     + (rel * torch.from_numpy(w_rel)).sum()).backward()
    np.testing.assert_allclose(ent.detach().numpy(), np.asarray(want_ent),
                               **F32_TOL)
    want = jax_leaves(grads)
    for name in jax_leaf_names(port.cfg)[0]:
        if name.startswith("decoder."):
            continue
        w = want[name]
        np.testing.assert_allclose(
            port.get_parameter(name).grad.numpy(), w, rtol=1e-4,
            atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_schedules_other_than_contrib_need_the_pallas_path(toy_cfg):
    """Without ``use_pallas`` (the JAX package's ``scatter.py`` path)
    ``bwd_perm`` is not read: ``operands`` and ``fwdw`` run K4b under
    ``ew_impl=pallas`` as ``contrib`` does, with the same gradients."""
    want, k4b = _schedule_grads(toy_cfg, ew_impl="pallas")
    assert k4b == 2
    for p in ("operands", "fwdw"):
        got, k4b = _schedule_grads(toy_cfg, ew_impl="pallas", bwd_perm=p)
        assert k4b == 2
        for name, g in want.items():
            torch.testing.assert_close(got[name], g, rtol=0, atol=0,
                                       msg=f"{p} {name}")
