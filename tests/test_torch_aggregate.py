"""The port's aggregation with its backward (kgc_gcn_torch/ops/scatter.py:
_Aggregate, segment_sum_few) against ``jax.grad`` of the JAX package's
``aggregate_half_pallas``, whose Pallas kernels run in interpret mode here.

Gradients with respect to x, rel_all and the per-edge table, in float32 and
in the bf16 message mode, with the relation gradient through both branches
of ``segment_sum_few`` (the dense sum at the default limit, K1's plain
version over the rel-sorted view at limit 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgc_gcn_tpu.ops.spmm_pallas import aggregate_half_pallas

from kgc_gcn_torch.ops.scatter import ONEHOT_LIMIT, aggregate_half, segment_sum_few
from kgc_gcn_torch.ops.segment_sum import segment_sum_reference
from test_torch_common import port_toy

# float32: the JAX Pallas segment-sum feeds its one-hot MXU product the
# messages split into two bf16 halves (hi/lo), which keeps ~2**-17 of each
# message, and sums in another order than the port
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16 messages: the two packages round the same float32 products to bf16,
# but a product one ulp apart in float32 can round to neighbouring bf16
# values (2**-8 relative)
BF16_TOL = dict(rtol=1e-2, atol=1e-3)


def _inputs(graph, n_ent, n_rel, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return (f(n_ent, d), f(2 * n_rel + 1, d), f(graph.e_pad, d),
            f(n_ent, d))   # x, rel_all, etab, cotangent


@pytest.mark.parametrize("few_limit", [0, ONEHOT_LIMIT])
@pytest.mark.parametrize("msg_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("half_name", ["inb", "outb"])
def test_aggregate_backward_matches_jax(toy, msg_dtype, few_limit, half_name):
    ds, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    n_ent, d = ds.num_entity, 8
    x, rel_all, etab, cot = _inputs(pgraph, n_ent, ds.num_relation, d, seed=7)
    jhalf = getattr(jgraph, half_name)

    def jax_fn(x_, r_, e_):
        out = aggregate_half_pallas(x_, r_, e_, jhalf, n_ent, interpret=True,
                                    msg_dtype=msg_dtype)
        return jnp.sum(out * cot), out

    (_, want_out), want_g = jax.value_and_grad(
        jax_fn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(rel_all), jnp.asarray(etab))

    args = [torch.from_numpy(a).requires_grad_() for a in (x, rel_all, etab)]
    out = aggregate_half(*args, getattr(pgraph, half_name), n_ent, msg_dtype,
                         few_limit=few_limit)
    got_g = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), args)

    tol = F32_TOL if msg_dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               err_msg="forward", **tol)
    for got, want, name in zip(got_g, want_g, ("d_x", "d_rel", "d_etab")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **tol)
    # zero-norm padding edges give their table rows no gradient
    e_real = getattr(pgraph, half_name).e_real
    assert float(got_g[2][e_real:].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_few_branches_agree(dtype):
    """Both branches of segment_sum_few equal a float64 sum into the
    relation rows, on dyadic values (exact in any order)."""
    _, pgraph, _ = port_toy()
    half = pgraph.outb
    n_seg = int(half.r_indptr.shape[0]) - 1
    rng = np.random.default_rng(3)
    vals = torch.from_numpy(
        rng.integers(-511, 512, size=(pgraph.e_pad, 5)) / 256).to(dtype)
    rdata = (half.rperm, half.r_indptr, half.r_rel)
    want = np.zeros((n_seg, 5))
    np.add.at(want, half.rel.numpy(), vals.double().numpy())
    calls = []

    def seg_sum(*a):
        calls.append(a[0].shape)
        return segment_sum_reference(*a)

    for limit in (0, ONEHOT_LIMIT):
        got = segment_sum_few(vals, half.rel, n_seg, rdata, seg_sum, limit)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    assert calls == [(pgraph.e_pad, 5)]   # only limit 0 takes the segment-sum
