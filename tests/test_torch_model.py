"""The port's MGCN + ConvE against the JAX package's on the same weights
(kgc_gcn_torch/models/{common,decoders,mgcn}.py, ops/scatter.py), eval mode.

Weights come from a JAX ``model.init`` with randomized BN statistics and
entity bias, carried across by convert.params_from_numpy.  With
``use_pallas=True`` the JAX encoder runs its Pallas kernel in interpret mode
on the CPU (models/mgcn.py picks it off the TPU).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgc_gcn_tpu.models.common import BNParams, BNState
from kgc_gcn_tpu.models.common import batch_norm as jax_batch_norm

from kgc_gcn_torch.models import build_model
from kgc_gcn_torch.models.common import batch_norm
from test_torch_common import jax_and_port_models, port_cfg, port_toy

# encode: float32 sums in another order, through BN and tanh
ENC_TOL = 1e-5
# logits: one more (B, N, d_out) product and the ConvE trunk on top
LOGIT_TOL = 1e-4
# bf16 operands: one upstream ulp can move a bf16 rounding by 2**-8 relative
BF16_TOL = 2e-2


def _queries(ds):
    src = np.array([0, 3, 5, 1, 11], np.int32)
    rel = np.array([0, 1, 2 * ds.num_relation - 1, 2, 5], np.int32)
    return src, rel


@pytest.mark.parametrize("use_pallas,compute_dtype", [
    (True, "float32"), (False, "float32"), (True, "bfloat16")])
def test_encode_and_logits_match_jax(toy, toy_cfg, use_pallas, compute_dtype):
    cfg = toy_cfg.replace(use_pallas=use_pallas, compute_dtype=compute_dtype)
    model, params, state, port = jax_and_port_models(toy, cfg, seed=1)
    ds, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    src, rel = _queries(ds)

    j_ent, j_rel, _ = model.encode(params, state, jgraph, train=False)
    j_logits, _ = model.decode(params, state, j_ent, j_rel, jnp.asarray(src),
                               jnp.asarray(rel), train=False)
    with torch.no_grad():
        p_ent, p_rel = port.encode(pgraph)
        p_logits = port.decode(p_ent, p_rel, torch.from_numpy(src),
                               torch.from_numpy(rel))

    enc_tol = ENC_TOL if compute_dtype == "float32" else BF16_TOL
    logit_tol = LOGIT_TOL if compute_dtype == "float32" else BF16_TOL
    for got, want in ((p_ent, j_ent), (p_rel, j_rel)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=enc_tol, atol=enc_tol)
    np.testing.assert_allclose(p_logits.numpy(), np.asarray(j_logits),
                               rtol=logit_tol, atol=logit_tol)
    # the randomized BN statistics are in play (eval BN is no identity)
    assert float(port.conv.bn.var.min()) != 1.0


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("axis", [1, -1])
def test_batch_norm_matches_jax(train, axis):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 5, 3)).astype(np.float32)
    c = x.shape[axis]
    scale, bias = rng.uniform(0.5, 1.5, c), rng.normal(0, 0.3, c)
    mean, var = rng.normal(0, 0.3, c), rng.uniform(0.5, 2.0, c)
    f = lambda a: np.asarray(a, np.float32)
    j_y, j_state = jax_batch_norm(
        jnp.asarray(x), BNParams(jnp.asarray(f(scale)), jnp.asarray(f(bias))),
        BNState(jnp.asarray(f(mean)), jnp.asarray(f(var))), train=train,
        channel_axis=axis)
    t = lambda a: torch.from_numpy(f(a))
    y, new_mean, new_var = batch_norm(t(x), t(scale), t(bias), t(mean),
                                      t(var), train=train, channel_axis=axis)
    np.testing.assert_allclose(y.numpy(), np.asarray(j_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(new_mean.numpy(), np.asarray(j_state.mean),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(new_var.numpy(), np.asarray(j_state.var),
                               rtol=1e-6, atol=1e-6)


def test_init_shapes_and_bounds(toy_cfg):
    """Layout and xavier bounds of a fresh port model (bound from the
    reference edge-table shape (2E, d_in) for the positional table)."""
    ds, graph, _ = port_toy()
    cfg = port_cfg(toy_cfg)
    m = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                    e_pad=graph.e_pad,
                    generator=torch.Generator().manual_seed(0)).requires_grad_(False)
    d_in, d_out = cfg.gcn_in_dim, cfg.gcn_out_dim
    assert m.edge_embeddings.shape == (2, graph.e_pad, d_in)
    assert m.conv.in_weight.shape == (d_in, d_out)
    assert m.decoder.conv_w.shape == (cfg.num_filter, 1, cfg.kernel_size,
                                      cfg.kernel_size)
    b_edge = (6.0 / (2 * ds.num_edge + d_in)) ** 0.5
    assert float(m.edge_embeddings.abs().max()) <= b_edge
    b_in = (6.0 / (d_in + d_out)) ** 0.5
    assert float(m.conv.in_weight.abs().max()) <= b_in
    assert float(m.conv.in_weight.abs().max()) > 0.5 * b_in


@pytest.mark.parametrize("override", [
    dict(model="rgcn", entity_sharded="gather"),
    dict(model="rgat", entity_sharded="ring"), dict(entity_sharded="ring"),
    dict(entity_sharded="boundary"), dict(entity_sharded="gather")])
def test_unported_configurations_raise(toy_cfg, override):
    """The entity-sharded schedules without a mesh (or RGAT's ring): the
    ValueError the JAX package raises for the same configuration
    (tests/test_torch_entity_sharding.py runs them on a mesh)."""
    from kgc_gcn_tpu.models import build_model as jax_build_model
    jcfg = toy_cfg.replace(**override)
    with pytest.raises(ValueError) as jax_err:
        jax_build_model(jcfg, 12, 4, 40)
    cfg = dataclasses.replace(port_cfg(toy_cfg), **override)
    with pytest.raises(ValueError) as err:
        build_model(cfg, 12, 4, 40)
    for words in ("gather' only", "needs a (data, graph) mesh",
                  "basis decomposition only"):
        assert (words in str(err.value)) == (words in str(jax_err.value))
