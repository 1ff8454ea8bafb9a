"""MGCN at depth and with the ``sub`` and ``corr`` compositions in the port
against the JAX package (kgc_gcn_torch/models/mgcn.py, ops/scatter.py,
convert.py, cli.py): the leaf map and the parameter round trip at 2 and 3
layers, the train-mode encode, its gradients and BatchNorm statistics at 2
and 3 layers under each composition, the per-half backward of ``sub`` and
``corr`` against JAX's autodiff, the dropout sites, and the refused
combinations in both packages and CLIs.

The toy graph with d_in 8 and d_out 32; weights come from the JAX model's
init with randomized BN statistics and entity bias, carried across by
convert.py.  Dropout is off: the two random streams differ.  JAX runs its
XLA aggregation (``use_pallas=False``), the only path on which it composes
by ``sub`` and ``corr``; the port sums through K1's plain version.
Tolerances: encode 1e-5 (float32 sums in another order, through BN and
tanh; ``corr`` through an FFT in another library: 1e-4), gradients
``GRAD_RTOL`` with the absolute part relative to each tensor's largest and
its floor, BN statistics rtol 1e-5 / atol 1e-6 (tests/test_torch_train.py).
Under ``sub`` every layer's ``loop_rel`` shifts each column of the loop
term by a constant, which the layer's train-mode BatchNorm removes: its
true gradient is 0 and both packages leave float noise there, so its
absolute tolerance is relative to the largest gradient of the step (as
chip_smoke.py's ``cancelling`` leaves).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgc_gcn_tpu import cli as jax_cli
from kgc_gcn_tpu.data.toy import write_toy
from kgc_gcn_tpu.models import build_model as jax_build_model
from kgc_gcn_tpu.ops.scatter import aggregate_half as jax_aggregate_half

from kgc_gcn_torch import cli
from kgc_gcn_torch.convert import (
    jax_leaf_names, params_from_numpy, params_to_numpy)
from kgc_gcn_torch.models import build_model
from kgc_gcn_torch.ops.scatter import aggregate_half
from test_torch_common import jax_and_port_models, jax_leaves, port_cfg, port_toy

ENC_TOL = {"mult": 1e-5, "sub": 1e-5, "corr": 1e-4}
GRAD_RTOL, GRAD_ATOL, GRAD_FLOOR = 2e-4, 2e-5, 1e-7
BN_TOL = dict(rtol=1e-5, atol=1e-6)


def cancelled(name: str, composition: str) -> bool:
    """A direction that the layer's train-mode BatchNorm cancels."""
    return composition == "sub" and name.endswith("loop_rel")


def depth_cfg(toy_cfg, layers, composition="mult", **kw):
    return toy_cfg.replace(num_layers=layers, composition=composition,
                           gcn_drop=0.0, conv_drop=0.0, feat_drop=0.0,
                           hidden_drop=0.0, **kw)


def close(got, want, rtol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def close_grad(got, want, what, g_max=None):
    """``g_max``: the step's largest gradient, for a cancelled direction."""
    scale = np.abs(want).max() if g_max is None else g_max
    np.testing.assert_allclose(
        got, want, rtol=GRAD_RTOL,
        atol=max(GRAD_FLOOR, GRAD_ATOL * scale), err_msg=what)


@pytest.mark.parametrize("layers", [2, 3])
def test_depth_leaves_pin_the_flatten_order_and_round_trip(toy, toy_cfg,
                                                            layers):
    """jax_leaf_names lists the JAX leaves of a deep MGCN in flatten order
    (``extra_convs``, ``extra_edge_embeddings``, ``extra_bn``); JAX params
    exported as numpy load into the port and come back unchanged."""
    cfg = depth_cfg(toy_cfg, layers)
    ds, graph, _ = toy
    _, params, state, port = jax_and_port_models(toy, cfg, seed=layers)
    p_names, s_names = jax_leaf_names(port_cfg(cfg))
    want_p, want_s = jax_leaves(params), jax_leaves(state)
    assert list(want_p) == p_names and list(want_s) == s_names
    n_extra = layers - 1
    assert len(p_names) == 21 + 9 * n_extra and len(s_names) == 8 + 2 * n_extra
    assert port.extra_edge_embeddings[n_extra - 1].shape == (2, graph.e_pad,
                                                             cfg.gcn_out_dim)
    assert sorted(params_from_numpy(want_p, want_s)) == sorted(
        port.state_dict())
    got_p, got_s = params_to_numpy(port, port.cfg)
    for want, got in ((want_p, got_p), (want_s, got_s)):
        assert list(got) == list(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("composition", ["mult", "sub", "corr"])
@pytest.mark.parametrize("layers", [2, 3])
def test_depth_encode_grads_and_bn_match_jax(toy, toy_cfg, layers,
                                             composition):
    """Train-mode encode (BN on batch statistics): all_ent, all_rel, the
    gradient of every encoder parameter of a weighted sum of both, and every
    layer's new BN running statistics, against JAX ``MGCN.encode``."""
    cfg = depth_cfg(toy_cfg, layers, composition)
    model, params, state, port = jax_and_port_models(toy, cfg, seed=5)
    _, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    rng = np.random.default_rng(6)
    w_ent = rng.normal(size=(jgraph.n_ent, 32)).astype(np.float32)
    w_rel = rng.normal(size=(2 * jgraph.n_rel, 32)).astype(np.float32)

    def f(p):
        ent, rel, aux = model.encode(p, state, jgraph, train=True, rngs={})
        return jnp.sum(ent * w_ent) + jnp.sum(rel * w_rel), (ent, rel, aux)
    (_, (want_ent, want_rel, (bn, extra))), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(params)
    want_grads = jax_leaves(grads)

    ent, rel = port.encode(pgraph, train=True, rngs={})
    ((ent * torch.from_numpy(w_ent)).sum()
     + (rel * torch.from_numpy(w_rel)).sum()).backward()
    tol = ENC_TOL[composition]
    close(ent.detach(), want_ent, tol, "all_ent")
    close(rel.detach(), want_rel, tol, "all_rel")
    names = [n for n in jax_leaf_names(port.cfg)[0]
             if not n.startswith("decoder.")]
    g_max = max(np.abs(want_grads[n]).max() for n in names)
    for name in names:
        close_grad(port.get_parameter(name).grad.numpy(), want_grads[name],
                   name, g_max if cancelled(name, composition) else None)
    got_state = params_to_numpy(port, port.cfg)[1]
    want_state = {f"{pre}.{k}": np.asarray(getattr(s_, k))
                  for pre, s_ in [("conv_bn", bn)] + [
                      (f"extra_bn.{i}", e) for i, e in enumerate(extra)]
                  for k in ("mean", "var")}
    assert len(want_state) == 2 * layers
    for name, v in want_state.items():
        np.testing.assert_allclose(got_state[name], v, err_msg=name, **BN_TOL)


@pytest.mark.parametrize("composition", ["sub", "corr"])
def test_composed_half_backward_matches_jax_autodiff(toy, composition):
    """The per-half aggregate of ``sub`` and ``corr`` and its gradients with
    respect to x, rel_all and the edge table (the cotangents of phi, then
    the K1 sums in src and rel order) against JAX's autodiff of its XLA
    ``aggregate_half``."""
    _, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    rng = np.random.default_rng(7)
    d = 12
    x = rng.normal(size=(jgraph.n_ent, d)).astype(np.float32)
    rel = rng.normal(size=(2 * jgraph.n_rel + 1, d)).astype(np.float32)
    etab = rng.normal(size=(jgraph.e_pad, d)).astype(np.float32)
    g = rng.normal(size=(jgraph.n_ent, d)).astype(np.float32)
    jhalf = jgraph.outb
    want, vjp = jax.vjp(
        lambda a, b, c: jax_aggregate_half(a, b, c, jhalf, jgraph.n_ent,
                                           composition), x, rel, etab)
    want_grads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, rel, etab)]
    out = aggregate_half(*ts, pgraph.outb, pgraph.n_ent, few_limit=0,
                         composition=composition)
    out.backward(torch.from_numpy(g))
    close(out.detach(), want, 1e-5, "aggregate")
    for t, w, what in zip(ts, want_grads, ("d_x", "d_rel", "d_etab")):
        close_grad(t.grad.numpy(), np.asarray(w), what)


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_dropout_and_sampling_sites_match_jax(toy, toy_cfg, layers):
    ds, graph, _ = toy
    cfg = toy_cfg.replace(num_layers=layers)
    jmodel = jax_build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                             e_pad=graph.e_pad)
    port = build_model(port_cfg(cfg), ds.num_entity, ds.num_relation,
                       ds.num_edge, e_pad=graph.e_pad)
    assert (sorted(port.make_rngs(torch.Generator()))
            == sorted(jmodel.make_rngs(jax.random.PRNGKey(0))))


REFUSED = [dict(composition="corr", use_pallas=True),
           dict(composition="sub", edge_sample_size=8),
           dict(composition="corr", agg_schedule="reference"),
           dict(num_layers=2, edge_sample_size=8)]


@pytest.mark.parametrize("override", REFUSED)
def test_refused_combinations_raise_the_jax_text(toy, toy_cfg, override):
    ds, graph, _ = toy
    cfg = toy_cfg.replace(**override)
    with pytest.raises(ValueError) as want:
        jax_build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=graph.e_pad)
    with pytest.raises(ValueError) as got:
        build_model(port_cfg(cfg), ds.num_entity, ds.num_relation,
                    ds.num_edge, e_pad=graph.e_pad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("override", [dict(composition="corr",
                                           spmm_mode="stacked"),
                                      dict(composition="sub",
                                           ew_impl="pallas")])
def test_multiplicative_schedules_refuse_sub_and_corr(toy_cfg, override):
    """K3 and K4a/K4b compose by multiplication only."""
    with pytest.raises(ValueError, match="compose by multiplication"):
        build_model(port_cfg(toy_cfg).replace(**override), 12, 4, 40)


@pytest.mark.parametrize("flags", [
    ["--use_pallas", "--composition", "corr"],
    ["--composition", "sub", "--edge_sample_size", "8"],
    ["--num_layers", "2", "--edge_sample_size", "8"]])
def test_both_clis_refuse_the_same_flags(tmp_path, flags):
    write_toy(str(tmp_path / "data"))
    base = ["--dataset", "Toy", "--data_dir", str(tmp_path / "data"),
            "--do_train", "--max_epoch", "1"]
    with pytest.raises(ValueError) as want:
        jax_cli.main(base + ["--experiments_dir", str(tmp_path / "j")]
                     + flags)
    with pytest.raises(ValueError) as got:
        cli.main(base + ["--experiments_dir", str(tmp_path / "p"),
                         "--device", "cpu"] + flags)
    assert str(got.value) == str(want.value)


def test_a_preset_use_pallas_yields_as_in_the_jax_cli():
    """``--dataset WN18RR`` (whose preset sets use_pallas) with ``--composition
    corr`` runs the composition in both CLIs; ``--use_pallas`` keeps it."""
    for flags, want in ((["--composition", "corr"], False),
                        (["--composition", "corr", "--use_pallas"], True),
                        ([], True)):
        argv = ["--dataset", "WN18RR"] + flags
        jcfg = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
        pcfg = cli.config_from_args(cli.build_parser().parse_args(argv))
        assert jcfg.use_pallas == pcfg.use_pallas == want, flags
