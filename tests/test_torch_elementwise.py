"""The port's ``ew_impl=pallas`` path (kgc_gcn_torch/ops/elementwise.py,
ops/scatter.py:_Aggregate with ``ew``) against the JAX package.

K4a's and K4b's plain versions are held against ``compose_msg_pad`` and
``bwd_products`` of ``kgc_gcn_tpu/ops/elementwise_pallas.py`` in interpret
mode, on an edge count that is a multiple of 128 (their tile).  The ``ew``
aggregation's forward and VJP are held against ``aggregate_half_pallas(...,
ew_pallas=True)``: in interpret mode the JAX package skips its ``ew`` kernels
(``spmm_pallas.py:560,651``) and composes the forward message in the order
``(x[src] * rg * etab) * norm``, where the port's K4a composes
``(x[src] * norm) * rg * etab``; the two differ at rounding level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgc_gcn_tpu.ops.elementwise_pallas import bwd_products as jax_bwd_products
from kgc_gcn_tpu.ops.elementwise_pallas import compose_msg_pad
from kgc_gcn_tpu.ops.spmm_pallas import aggregate_half_pallas

from kgc_gcn_torch.ops.elementwise import (
    bwd_products, bwd_products_reference, compose_msg, compose_msg_reference)
from kgc_gcn_torch.ops.kernels import KERNELS, PLAIN
from kgc_gcn_torch.ops.scatter import aggregate_half
from test_torch_aggregate import BF16_TOL, F32_TOL, _inputs
from test_torch_common import port_toy

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _operands(n: int, e: int = 256, d: int = 20, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(e, d)).astype(np.float32) for _ in range(n)]


def _as_f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_compose_msg_plain_matches_jax_kernel(out_dtype):
    """The same float32 products in the same order, then the same rounding:
    equal to the bit."""
    xgn, rg, et = _operands(3)
    want = compose_msg_pad(*map(jnp.asarray, (xgn, rg, et)), xgn.shape[1],
                           out_dtype, interpret=True)
    args = [torch.from_numpy(a) for a in (xgn, rg, et)]
    got = compose_msg_reference(*args, _TORCH[out_dtype])
    assert got.dtype == _TORCH[out_dtype] and got.shape == xgn.shape
    np.testing.assert_array_equal(got.float().numpy(), _as_f32(want))
    # on CPU tensors the wrapper is the plain version
    torch.testing.assert_close(compose_msg(*args, _TORCH[out_dtype]), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_bwd_products_plain_matches_jax_kernel(out_dtype):
    gdn, xg, rg, et = _operands(4, d=100, seed=1)
    want = jax_bwd_products(*map(jnp.asarray, (gdn, xg, rg, et)), out_dtype,
                            interpret=True)
    args = [torch.from_numpy(a) for a in (gdn, xg, rg, et)]
    got = bwd_products_reference(*args, _TORCH[out_dtype])
    assert [t.dtype for t in got] == [_TORCH[out_dtype]] * 2 + [torch.float32]
    for g, w, name in zip(got, want, ("contrib", "d_rel_in", "d_etab")):
        np.testing.assert_array_equal(g.float().numpy(), _as_f32(w),
                                      err_msg=name)
    for g, w in zip(bwd_products(*args, _TORCH[out_dtype]), got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_elementwise_wrappers_check_their_operands():
    xgn, rg, et = (torch.from_numpy(a) for a in _operands(3))
    with pytest.raises(ValueError, match="one shape"):
        compose_msg(xgn, rg[:-1], et)
    with pytest.raises(ValueError, match="float32"):
        compose_msg(xgn.double(), rg, et)
    with pytest.raises(ValueError, match="out_dtype"):
        bwd_products(xgn, xgn, rg, et, torch.float16)


@pytest.mark.parametrize("msg_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("half_name", ["inb", "outb"])
def test_ew_aggregate_matches_jax(toy, msg_dtype, half_name):
    """Forward and the gradients with respect to x, rel_all and the edge
    table, through the plain K4a/K4b (the wrappers on CPU tensors) and
    through PLAIN's, against ``aggregate_half_pallas(ew_pallas=True)``."""
    ds, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    n_ent, d = ds.num_entity, 8
    x, rel_all, etab, cot = _inputs(pgraph, n_ent, ds.num_relation, d, seed=9)
    jhalf = getattr(jgraph, half_name)

    def jax_fn(x_, r_, e_):
        out = aggregate_half_pallas(x_, r_, e_, jhalf, n_ent, interpret=True,
                                    msg_dtype=msg_dtype, ew_pallas=True)
        return jnp.sum(out * cot), out

    (_, want_out), want_g = jax.value_and_grad(
        jax_fn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(rel_all), jnp.asarray(etab))

    tol = F32_TOL if msg_dtype == "float32" else BF16_TOL
    for kernels in (KERNELS, PLAIN):
        args = [torch.from_numpy(a).requires_grad_() for a in (x, rel_all, etab)]
        out = aggregate_half(*args, getattr(pgraph, half_name), n_ent,
                             msg_dtype, kernels.seg_sum,
                             ew=(kernels.compose_msg, kernels.bwd_products))
        got_g = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), args)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                                   err_msg="forward", **tol)
        for got, want, name in zip(got_g, want_g, ("d_x", "d_rel", "d_etab")):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=name, **tol)
        e_real = getattr(pgraph, half_name).e_real
        assert float(got_g[2][e_real:].abs().max()) == 0.0
