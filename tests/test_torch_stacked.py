"""MGCN's aggregation schedules in the port against the JAX package: the
stacked graph view (kgc_gcn_torch/data/graph.py:GraphStacked), K3's plain
version and ``aggregate_stacked`` (ops/fused_compose.py),
``aggregate_stacked_xla`` (ops/scatter.py), and MGCN + ConvE under
``spmm_mode`` ``stacked`` and ``stacked_xla`` and ``ew_impl=pallas``
(models/mgcn.py), up to one training step and a CLI run on Toy.

The JAX package's stacked kernel (K3) and segment-sum run in interpret mode
here.  K3 splits the relation rows and the messages into hi/lo bf16 halves,
which keep ~2**-17 of each value, and its sums run in another order:
``F32_TOL`` (rtol 1e-4, atol 1e-5), as for the halves path.
"""

import dataclasses
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kgc_gcn_tpu.config import Config as JaxConfig
from kgc_gcn_tpu.data.batching import make_banks as jax_make_banks
from kgc_gcn_tpu.data.dataset import load_dataset as jax_load_dataset
from kgc_gcn_tpu.data.graph import build_graph as jax_build_graph
from kgc_gcn_tpu.data.toy import write_toy
from kgc_gcn_tpu.models import build_model as jax_build_model
from kgc_gcn_tpu.ops.spmm_pallas import (
    _fused_compose_segment_sum, aggregate_half_pallas,
    aggregate_stacked_pallas)
from kgc_gcn_tpu.ops.spmm_pallas import \
    aggregate_stacked_xla as jax_aggregate_stacked_xla
from kgc_gcn_tpu.train import loop as jloop
from kgc_gcn_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from kgc_gcn_tpu.train.optim import make_optimizer

from kgc_gcn_torch import cli
from kgc_gcn_torch.convert import jax_leaf_names
from kgc_gcn_torch.data.graph import build_graph
from kgc_gcn_torch.models import build_model
from kgc_gcn_torch.ops.fused_compose import (
    aggregate_stacked, fused_compose, fused_compose_reference)
from kgc_gcn_torch.ops.kernels import PLAIN
from kgc_gcn_torch.ops.scatter import aggregate_half, aggregate_stacked_xla
from kgc_gcn_torch.train import loop as ploop
from test_torch_aggregate import BF16_TOL, F32_TOL
from test_torch_common import (
    jax_and_port_models, jax_leaves, port_cfg, port_toy)

# one step's gradients: float32 sums in another order through the encoder,
# the decoder and the loss (and the JAX K3's hi/lo products), the absolute
# part relative to each tensor's largest gradient
GRAD_RTOL, GRAD_ATOL, GRAD_FLOOR = 2e-4, 2e-5, 1e-7
# ConvE's degenerate directions (tests/test_torch_train.py): float noise
# (bn0's scale too, degenerate up to BN1's eps: the ew schedule's compose
# order moves its ~1e-6 gradient by ~1e-7)
DEGENERATE = ("decoder.bn0.bias", "decoder.bn0.scale", "decoder.fc_b")
NOISE = 1e-5
SCHEDULES = {"stacked": dict(spmm_mode="stacked"),
             "stacked_xla": dict(spmm_mode="stacked_xla"),
             "ew_pallas": dict(ew_impl="pallas")}


def _stacked_fields_equal(pgraph, jgraph):
    st, jst = pgraph.stacked, jgraph.stacked
    for f in dataclasses.fields(st):
        np.testing.assert_array_equal(getattr(st, f.name).numpy(),
                                      np.asarray(getattr(jst, f.name)),
                                      err_msg=f.name)


def _random_triples(seed: int):
    """A random graph with ragged counts, a hub source entity and empty
    rows (tests/test_pallas.py:161-205)."""
    rng = np.random.default_rng(100 + seed)
    n_ent, n_rel, e = (int(rng.integers(5, 60)), int(rng.integers(1, 6)),
                       int(rng.integers(3, 200)))
    src = np.where(rng.random(e) < 0.3, 0, rng.integers(n_ent, size=e))
    tri = np.stack([src, rng.integers(n_rel, size=e),
                    rng.integers(n_ent, size=e)], axis=1).astype(np.int64)
    return tri, n_ent, n_rel, rng


def test_graph_stacked_matches_jax(toy):
    _, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    _stacked_fields_equal(pgraph, jgraph)
    st, n = pgraph.stacked, pgraph.n_ent
    assert st.dst is st.dst2 and st.indptr.shape == (2 * n + 1,)
    assert bool((st.dst2[1:] >= st.dst2[:-1]).all())
    # the concatenation is the two halves, the out-half offset by N
    e_pad = pgraph.e_pad
    torch.testing.assert_close(st.dst2[e_pad:], pgraph.outb.dst + n)
    torch.testing.assert_close(st.norm[:e_pad], pgraph.inb.norm)
    moved = pgraph.to("cpu")
    assert dataclasses.fields(moved.stacked) == dataclasses.fields(st)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregations_fuzz_random_graphs(seed):
    """Random graphs: the stacked view field for field, and the forward and
    every gradient of ``aggregate_stacked`` (K3's plain version),
    ``aggregate_stacked_xla`` and the ``ew`` halves against the JAX
    package's ``aggregate_stacked_pallas``, ``aggregate_stacked_xla`` and
    ``aggregate_half_pallas``."""
    tri, n_ent, n_rel, rng = _random_triples(seed)
    # the JAX package's numpy graph construction, which the port copies: its
    # native one rounds the degree norm as 1/sqrt(deg), one ulp off
    # deg**-0.5 for some degrees
    jg = jax_build_graph(tri, n_ent, n_rel, pad_to=8, use_native=False)
    pg = build_graph(tri, n_ent, n_rel, pad_to=8)
    _stacked_fields_equal(pg, jg)
    d = int(rng.choice([4, 8, 16]))
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x, rel, et2, w = f(n_ent, d), f(2 * n_rel + 1, d), f(2 * pg.e_pad, d), \
        f(2 * n_ent, d)

    def stacked_jax(x_, r_, e_):
        a, b = aggregate_stacked_pallas(x_, r_, e_, jg.stacked, n_ent, True)
        return jnp.concatenate([a[:, :d], b[:, :d]])

    def halves_jax(x_, r_, e_):
        return jnp.concatenate([aggregate_half_pallas(
            x_, r_, e_[i * pg.e_pad:(i + 1) * pg.e_pad], h, n_ent, True,
            ew_pallas=True) for i, h in enumerate((jg.inb, jg.outb))])

    def halves_port(x_, r_, e_):
        ew = (PLAIN.compose_msg, PLAIN.bwd_products)
        return torch.cat([aggregate_half(
            x_, r_, e_[i * pg.e_pad:(i + 1) * pg.e_pad], h, n_ent,
            seg_sum=PLAIN.seg_sum, ew=ew) for i, h in enumerate((pg.inb, pg.outb))])

    cases = (
        (stacked_jax, lambda *a: torch.cat(aggregate_stacked(
            *a, pg.stacked, n_ent))),
        (lambda *a: jnp.concatenate(jax_aggregate_stacked_xla(
            *a, jg.stacked, n_ent, True)),
         lambda *a: torch.cat(aggregate_stacked_xla(*a, pg.stacked, n_ent))),
        (halves_jax, halves_port))
    for jfn, pfn in cases:
        want_out, vjp = jax.vjp(jfn, *map(jnp.asarray, (x, rel, et2)))
        want_g = vjp(jnp.asarray(w))
        args = [torch.from_numpy(a).requires_grad_() for a in (x, rel, et2)]
        out = pfn(*args)
        got_g = torch.autograd.grad(out, args, torch.from_numpy(w))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                                   err_msg=f"{pfn} forward", **F32_TOL)
        for got, want, name in zip(got_g, want_g, ("d_x", "d_rel", "d_etab")):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f"{pfn} {name}", **F32_TOL)


def test_fused_compose_plain_matches_jax_kernel(toy):
    """K3's plain version against ``_fused_compose_segment_sum`` fed the
    numpy-built ``xgn = x[src] * norm`` (lane-padded to 128, relation rows
    split hi/lo as ``_aggregate_stacked_cvjp`` does)."""
    ds, _, _ = toy
    _, pgraph, _ = port_toy()
    st, n_rows, d = pgraph.stacked, 2 * ds.num_entity, 8
    rng = np.random.default_rng(4)
    x = rng.normal(size=(ds.num_entity, d)).astype(np.float32)
    rel_all = rng.normal(size=(2 * ds.num_relation + 1, d)).astype(np.float32)
    etab = rng.normal(size=(2 * pgraph.e_pad, d)).astype(np.float32)
    src, rel, norm = st.src.numpy(), st.rel.numpy(), st.norm.numpy()
    pad = lambda a, rows=0: np.pad(a, ((0, rows), (0, 128 - d)))
    rel128 = jnp.asarray(pad(rel_all, -rel_all.shape[0] % 8))
    rel_hi = rel128.astype(jnp.bfloat16)
    rel_lo = (rel128 - rel_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    want = _fused_compose_segment_sum(
        jnp.asarray(pad(x[src] * norm[:, None])), jnp.asarray(pad(etab)),
        jnp.asarray(rel), jnp.asarray(st.dst2.numpy()), rel_hi, rel_lo,
        jnp.asarray(st.indptr.numpy()), n_rows, interpret=True)
    args = (torch.from_numpy(x), st.src, st.norm, torch.from_numpy(rel_all),
            st.rel, torch.from_numpy(etab), st.dst2, st.indptr, n_rows)
    got = fused_compose_reference(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:n_rows, :d],
                               **F32_TOL)
    torch.testing.assert_close(fused_compose(*args), got, rtol=0, atol=0)
    with pytest.raises(ValueError, match="indptr"):
        fused_compose(*args[:-2], st.indptr[:-1], n_rows)


@pytest.mark.parametrize("few_limit", [0, None])
@pytest.mark.parametrize("which,msg_dtype", [
    ("stacked", "float32"), ("stacked_xla", "float32"),
    ("stacked_xla", "bfloat16")])
def test_stacked_aggregations_match_jax(toy, which, msg_dtype, few_limit):
    """Forward and every gradient of the port's two stacked aggregations
    against the JAX package's, on the toy graph; ``few_limit=0`` takes the
    relation gradient through K1's plain version over the rel-sorted view."""
    ds, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    n, d = ds.num_entity, 8
    rng = np.random.default_rng(6)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x, rel_all, et2 = f(n, d), f(2 * ds.num_relation + 1, d), \
        f(2 * pgraph.e_pad, d)
    w_in, w_out = f(n, d), f(n, d)

    def jax_fn(x_, r_, e_):
        if which == "stacked":
            a, b = aggregate_stacked_pallas(x_, r_, e_, jgraph.stacked, n, True)
            a, b = a[:, :d], b[:, :d]
        else:
            a, b = jax_aggregate_stacked_xla(x_, r_, e_, jgraph.stacked, n,
                                             True, msg_dtype=msg_dtype)
        return jnp.sum(a * w_in) + jnp.sum(b * w_out), (a, b)

    (_, want_out), want_g = jax.value_and_grad(
        jax_fn, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (x, rel_all, et2)))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, rel_all, et2)]
    if which == "stacked":
        got_out = aggregate_stacked(*args, pgraph.stacked, n,
                                    few_limit=few_limit)
    else:
        got_out = aggregate_stacked_xla(*args, pgraph.stacked, n, msg_dtype,
                                        few_limit=few_limit)
    loss = ((got_out[0] * torch.from_numpy(w_in)).sum()
            + (got_out[1] * torch.from_numpy(w_out)).sum())
    got_g = torch.autograd.grad(loss, args)
    tol = F32_TOL if msg_dtype == "float32" else BF16_TOL
    for got, want in zip(got_out, want_out):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   err_msg="forward", **tol)
    for got, want, name in zip(got_g, want_g, ("d_x", "d_rel", "d_etab")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **tol)
    # zero-norm padding edges give their table rows no gradient
    e_pad, e_real = pgraph.e_pad, pgraph.inb.e_real
    assert float(got_g[2][e_real:e_pad].abs().max()) == 0.0


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_mgcn_schedule_matches_jax(toy, toy_cfg, schedule):
    """MGCN + ConvE under one schedule against the JAX model with
    ``use_pallas=True`` and the same field: eval encode and logits, then
    one dropout-free 1-vs-all training step's gradients (the JAX step with
    an identity optimizer at lr 1e4: grad = (p - new) / lr)."""
    lr = 1e4
    cfg = toy_cfg.replace(use_pallas=True, gcn_drop=0.0, conv_drop=0.0,
                          hidden_drop=0.0, feat_drop=0.0, lbl_smooth=0.1,
                          **SCHEDULES[schedule])
    model, params, state, port = jax_and_port_models(toy, cfg, seed=2)
    ds, jgraph, jbanks = toy
    _, pgraph, pbanks = port_toy()
    src = np.array([0, 3, 5, 1, 11], np.int32)
    rel = np.array([0, 1, 2 * ds.num_relation - 1, 2, 5], np.int32)

    j_ent, j_rel, _ = model.encode(params, state, jgraph, train=False)
    j_logits, _ = model.decode(params, state, j_ent, j_rel, jnp.asarray(src),
                               jnp.asarray(rel), train=False)
    with torch.no_grad():
        p_ent, p_rel = port.encode(pgraph)
        p_logits = port.decode(p_ent, p_rel, torch.from_numpy(src),
                               torch.from_numpy(rel))
    for got, want in ((p_ent, j_ent), (p_rel, j_rel), (p_logits, j_logits)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)

    bank = jbanks["train"]
    idx, mask = np.array([5, 2, 7, 0]), np.array([1, 1, 1, 0], np.float32)
    q, li = np.asarray(bank.queries)[idx], np.asarray(bank.label_idx)[idx]
    p0 = {k: np.array(v, copy=True) for k, v in jax_leaves(params).items()}
    trainer = jloop.Trainer(cfg, model, jgraph, jbanks)
    trainer.tx = optax.identity()
    new_p, _, _, j_loss = trainer._train_step_jit(
        params, state, trainer.tx.init(params), jgraph, jnp.float32(lr),
        jnp.asarray(q), jnp.asarray(li), jnp.asarray(mask),
        jax.random.PRNGKey(0))
    want = {k: (p0[k].astype(np.float64) - v.astype(np.float64)) / lr
            for k, v in jax_leaves(new_p).items()}
    ptrainer = ploop.Trainer(port.cfg, port, pgraph, pbanks)
    loss = ptrainer.loss(*(torch.from_numpy(a) for a in (q, li, mask)))
    grads = torch.autograd.grad(loss, ptrainer.params)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    for name, g in zip(jax_leaf_names(port.cfg)[0], grads):
        if name in DEGENERATE:
            assert max(np.abs(g.numpy()).max(), np.abs(want[name]).max()) < NOISE
            continue
        np.testing.assert_allclose(
            g.numpy(), want[name], rtol=GRAD_RTOL,
            atol=max(GRAD_FLOOR, GRAD_ATOL * np.abs(want[name]).max()),
            err_msg=name)
    assert np.abs(want["edge_embeddings"]).max() > 0


def test_one_parameter_set_encodes_alike_under_every_schedule(toy, toy_cfg):
    """The schedules change no parameter: one JAX parameter set, carried
    across by convert.py into a port model built for each schedule, encodes
    alike in both packages under all four (``halves`` the reference)."""
    cfg = toy_cfg.replace(use_pallas=True)
    jmodel, params, state, port = jax_and_port_models(toy, cfg, seed=3)
    ds, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    weights = port.state_dict()
    want, _, _ = jmodel.encode(params, state, jgraph, train=False)
    for schedule in ("halves",) + tuple(sorted(SCHEDULES)):
        scfg = cfg.replace(**SCHEDULES.get(schedule, {}))
        j_ent, _, _ = jax_build_model(
            scfg, ds.num_entity, ds.num_relation, ds.num_edge,
            e_pad=jgraph.e_pad).encode(params, state, jgraph, train=False)
        model = build_model(port_cfg(scfg), ds.num_entity, ds.num_relation,
                            ds.num_edge, e_pad=pgraph.e_pad)
        model.load_state_dict(weights)
        with torch.no_grad():
            p_ent, _ = model.eval().encode(pgraph)
        for got, who in ((np.asarray(j_ent), "jax"), (p_ent.numpy(), "port")):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{schedule} {who}")


def test_cli_trains_stacked_then_serves(tmp_path, caplog):
    """``--use_pallas --spmm_mode stacked --device cpu`` trains MGCN +
    ConvE on Toy and writes last.ckpt; ``--do_test`` with the same flags
    reports the metrics the JAX package computes from that checkpoint under
    the same schedule."""
    data_dir, exp = str(tmp_path / "data"), str(tmp_path / "exp")
    write_toy(data_dir, "Toy")
    base = ["--dataset", "Toy", "--data_dir", data_dir, "--device", "cpu",
            "--use_pallas", "--spmm_mode", "stacked"]
    assert cli.main(base + [
        "--do_train", "--max_epoch", "2", "--batch_size", "16",
        "--gcn_in_dim", "16", "--gcn_out_dim", "32", "--k_w", "4", "--k_h",
        "8", "--num_filter", "4", "--kernel_size", "3",
        "--experiments_dir", exp]) == 0
    run = tmp_path / "exp" / "Toy"
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 3 and (run / "last.ckpt").exists()
    assert all(np.isfinite(json.loads(x)["loss"]) for x in lines[1:])

    with caplog.at_level(logging.INFO):
        assert cli.main(base + ["--do_test", "--restore_dir", str(run),
                                "--experiments_dir", str(tmp_path / "t")]) == 0
    line = next(r.getMessage() for r in caplog.records
                if "Test metrics" in r.getMessage())
    got = dict(kv.split(": ") for kv in line.split("metrics: ")[1].strip()
               .split("; "))
    jcfg = JaxConfig.from_json(str(run / "params.json"))
    assert (jcfg.spmm_mode, jcfg.use_pallas) == ("stacked", True)
    ds = jax_load_dataset("Toy", data_dir)
    graph = jax_build_graph(ds.train_triples, ds.num_entity, ds.num_relation)
    jmodel = jax_build_model(jcfg, ds.num_entity, ds.num_relation, ds.num_edge)
    params, state = jmodel.init(jax.random.PRNGKey(0))
    tree, _ = jax_load_checkpoint(str(run), {
        "params": params, "state": state,
        "opt_state": make_optimizer(jcfg).init(params)})
    want = jloop.Trainer(jcfg, jmodel, graph, jax_make_banks(ds)).evaluate(
        tree["params"], tree["state"], "test", mark="Test")
    for k, v in want.items():
        assert float(got[k]) == pytest.approx(v, abs=1e-3), k   # log: 3 digits
