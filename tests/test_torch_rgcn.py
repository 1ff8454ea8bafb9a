"""R-GCN (basis) + DistMult in the port against the JAX package
(kgc_gcn_torch/models/{rgcn,family_base,decoders}.py, convert.py and
train/checkpoint.py for the family, cli.py): the leaf map, the encoder and
its gradients, the decoder, checkpoints both ways and a CLI run on Toy.

The toy graph with d_in 8, d_out 16 and B = 3 bases; weights come from the
JAX model's init with randomized entity bias and cross through convert.py.
Dropout is off.  Tolerances: 1e-4 (rtol, and atol relative to the largest
element) against the JAX encoder on its Pallas basis kernels in interpret
mode (hi/lo bf16 products), 1e-5 against its XLA path.
"""

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
from kgc_gcn_tpu.models.decoders import distmult_apply, distmult_score_candidates
from kgc_gcn_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from kgc_gcn_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from kgc_gcn_tpu.train.loop import Trainer as JaxTrainer
from kgc_gcn_tpu.train.optim import make_optimizer

from kgc_gcn_torch import cli
from kgc_gcn_torch.convert import jax_leaf_names, params_from_numpy, params_to_numpy
from kgc_gcn_torch.models import build_model
from kgc_gcn_torch.ops.kernels import PLAIN
from kgc_gcn_torch.train.checkpoint import load_checkpoint, save_checkpoint
from kgc_gcn_torch.train.loop import Trainer
from kgc_gcn_torch.train.negative import NegativeSamplingTrainer
from test_torch_common import (
    jax_and_port_models, jax_leaves, port_cfg, port_toy, rgcn_cfg)

KERNEL_RTOL = 1e-4
XLA_RTOL = 1e-5


def close(got, want, rtol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("layers", [1, 2])
def test_rgcn_leaf_names_pin_the_flatten_order(toy, toy_cfg, layers):
    cfg = rgcn_cfg(toy_cfg, num_layers=layers)
    ds, graph, _ = toy
    params, state = jax_build_model(cfg, ds.num_entity, ds.num_relation,
                                    ds.num_edge).init(jax.random.PRNGKey(0))
    p_names, s_names = jax_leaf_names(port_cfg(cfg))
    assert list(jax_leaves(params)) == p_names and s_names == []
    assert jax_leaves(state) == {}
    assert len(p_names) == 3 + 3 * layers
    port = build_model(port_cfg(cfg), ds.num_entity, ds.num_relation,
                       ds.num_edge)
    sd = params_from_numpy(jax_leaves(params), {})
    assert sorted(sd) == sorted(port.state_dict())
    for k, v in port.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    assert port.nb == 3 and port.layers[0].basis.shape == (3, 8, 16)


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["pallas_interpret", "xla"])
def test_rgcn_encode_and_grads_match_jax(toy, toy_cfg, use_pallas, layers):
    """all_ent, all_rel and the gradient of every encoder parameter of a
    weighted sum of both, against JAX ``RGCN.encode`` (its basis kernels in
    interpret mode with the band backward's plan, or its XLA path)."""
    cfg = rgcn_cfg(toy_cfg, num_layers=layers, use_pallas=use_pallas)
    model, params, state, port = jax_and_port_models(toy, cfg, seed=layers)
    _, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    model.prepare_kernels(jgraph)
    rng = np.random.default_rng(7)
    w_ent = rng.normal(size=(jgraph.n_ent, 16)).astype(np.float32)
    w_rel = rng.normal(size=(2 * jgraph.n_rel, 16)).astype(np.float32)

    def f(p):
        ent, rel, _ = model.encode(p, state, jgraph)
        return jnp.sum(ent * w_ent) + jnp.sum(rel * w_rel), ent
    (_, want_ent), grads = jax.value_and_grad(f, has_aux=True)(params)
    want_grads = jax_leaves(grads)

    ent, rel = port.encode(pgraph)
    loss = (ent * torch.from_numpy(w_ent)).sum() + (rel * torch.from_numpy(w_rel)).sum()
    loss.backward()
    tol = KERNEL_RTOL if use_pallas else XLA_RTOL
    close(ent.detach(), want_ent, tol, "all_ent")
    for name in jax_leaf_names(port.cfg)[0]:
        if name == "decoder.ent_bias":
            continue
        close(port.get_parameter(name).grad, want_grads[name], tol, name)
    # the plain bundle gives the same encode on the CPU
    ent_plain, _ = port.encode(pgraph, kernels=PLAIN)
    torch.testing.assert_close(ent_plain, ent.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_distmult_decode_and_candidates_match_jax(toy, toy_cfg, compute_dtype):
    cfg = rgcn_cfg(toy_cfg, compute_dtype=compute_dtype)
    model, params, state, port = jax_and_port_models(toy, cfg, seed=5)
    _, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    ent, rel, _ = model.encode(params, state, jgraph)
    rng = np.random.default_rng(8)
    src = rng.integers(0, jgraph.n_ent, size=6)
    r = rng.integers(0, 2 * jgraph.n_rel, size=6)
    cand = rng.integers(0, jgraph.n_ent, size=(6, 4))
    want, _ = distmult_apply(params.decoder, state.decoder, cfg, ent[src],
                             rel[r], ent, train=False)
    want_c, _ = distmult_score_candidates(params.decoder, state.decoder, cfg,
                                          ent[src], rel[r], ent[cand],
                                          jnp.asarray(cand), train=False)
    with torch.no_grad():
        pent, prel = port.encode(pgraph)
        t = lambda a: torch.from_numpy(np.asarray(a))
        got = port.decode(pent, prel, t(src), t(r))
        got_c = port.score_candidates(pent, prel, t(src), t(r), t(cand))
        h, bias = port.query_and_bias(pent, prel, t(src), t(r))
        trunk = h @ pent.T + bias                 # float32 trunk product
    close(got, want, XLA_RTOL, "decode")
    close(got_c, want_c, XLA_RTOL, "score_candidates")
    # candidates score as their column of the float32 trunk logits, which
    # are the decode logits when the decode product is float32 too
    torch.testing.assert_close(got_c, torch.gather(trunk, 1, t(cand)),
                               rtol=1e-6, atol=1e-6)
    if compute_dtype == "float32":
        torch.testing.assert_close(trunk, got, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", ["sparse", "fused", "dense"])
def test_rgcn_one_vs_all_step_gradients_match_jax(toy, toy_cfg, impl):
    """1-vs-all training of R-GCN + DistMult through the query trunk
    (``query_and_bias``; ``dense`` through ``decode``): loss and every
    gradient against JAX ``Trainer._train_step`` with an identity optimizer
    (grad = (p - new) / lr)."""
    lr = 1e4
    cfg = rgcn_cfg(toy_cfg, loss_impl=impl, lbl_smooth=0.1, batch_size=4)
    model, params, state, port = jax_and_port_models(toy, cfg, seed=4)
    _, jgraph, jbanks = toy
    _, pgraph, pbanks = port_toy()
    bank = jbanks["train"]
    idx = np.array([5, 2, 7, 0])                 # the last row is padding
    mask = np.array([1, 1, 1, 0], np.float32)
    q, li = np.asarray(bank.queries)[idx], np.asarray(bank.label_idx)[idx]
    p0 = {k: np.array(v, copy=True) for k, v in jax_leaves(params).items()}
    trainer = JaxTrainer(cfg, model, jgraph, jbanks)
    trainer.tx = optax.identity()
    new_p, _, _, j_loss = trainer._train_step_jit(
        params, state, trainer.tx.init(params), jgraph, jnp.float32(lr),
        jnp.asarray(q), jnp.asarray(li), jnp.asarray(mask),
        jax.random.PRNGKey(0))
    want = {k: (p0[k].astype(np.float64) - v.astype(np.float64)) / lr
            for k, v in jax_leaves(new_p).items()}
    ptrainer = Trainer(port_cfg(cfg), port, pgraph, pbanks)
    assert ptrainer.loss_impl == impl
    loss = ptrainer.loss(*(torch.from_numpy(a) for a in (q, li, mask)))
    grads = torch.autograd.grad(loss, ptrainer.params)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    for name, g in zip(jax_leaf_names(port.cfg)[0], grads):
        np.testing.assert_allclose(
            g.numpy(), want[name], rtol=2e-4,
            atol=max(1e-7, 2e-5 * np.abs(want[name]).max()), err_msg=name)


def _port_trained(toy_cfg, moment_dtype):
    """A port RGCN + its NegativeSamplingTrainer after two steps."""
    cfg = port_cfg(rgcn_cfg(toy_cfg, moment_dtype=moment_dtype,
                            train_mode="negative_sampling", seed=3))
    ds, graph, banks = port_toy()
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge)
    trainer = NegativeSamplingTrainer(cfg, model, graph, banks)
    mask = torch.ones(8)
    for s in range(2):
        trainer.train_step(1e-2, *trainer.batch(torch.arange(8 * s, 8 * s + 8),
                                                mask))
    return cfg, model, trainer


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_jax_reads_the_port_rgcn_checkpoint(toy, toy_cfg, tmp_path,
                                            moment_dtype):
    cfg, model, trainer = _port_trained(toy_cfg, moment_dtype)
    save_checkpoint(str(tmp_path), model, trainer.opt_state, cfg, 0.25)
    ds, _, _ = toy
    jcfg = rgcn_cfg(toy_cfg, moment_dtype=moment_dtype)
    params, state = jax_build_model(jcfg, ds.num_entity, ds.num_relation,
                                    ds.num_edge).init(jax.random.PRNGKey(0))
    tree, measure = jax_load_checkpoint(str(tmp_path), {
        "params": params, "state": state,
        "opt_state": make_optimizer(jcfg).init(params)})
    assert measure == 0.25
    ours = params_to_numpy(model, cfg)[0]
    want = jax_leaves(tree["params"])
    assert list(want) == list(ours)
    for name, v in want.items():
        np.testing.assert_array_equal(v, ours[name], err_msg=name)
    adam = tree["opt_state"][-1]
    assert int(adam.count) == trainer.opt_state.count == 2
    names = jax_leaf_names(cfg)[0]
    for moments, mine in ((adam.mu, trainer.opt_state.mu),
                          (adam.nu, trainer.opt_state.nu)):
        leaves = jax_leaves(moments)
        assert list(leaves) == names
        for name, t in zip(names, mine):
            np.testing.assert_array_equal(np.asarray(leaves[name], np.float32),
                                          t.float().numpy(), err_msg=name)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_port_reads_the_jax_rgcn_checkpoint(toy, toy_cfg, tmp_path,
                                            moment_dtype):
    """A JAX tree after two Adam updates of random gradients: the port's
    parameters and moments land on the leaves of the same name (a wrong
    leaf order would put a moment on another parameter)."""
    ds, _, _ = toy
    jcfg = rgcn_cfg(toy_cfg, moment_dtype=moment_dtype, num_layers=2)
    params, state = jax_build_model(jcfg, ds.num_entity, ds.num_relation,
                                    ds.num_edge).init(jax.random.PRNGKey(1))
    tx = make_optimizer(jcfg)
    opt = tx.init(params)
    rng = np.random.default_rng(9)
    for _ in range(2):
        g = jax.tree.map(lambda p: jnp.asarray(
            rng.normal(size=p.shape).astype(np.float32)), params)
        upd, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, upd)
    jax_save_checkpoint(str(tmp_path), {"params": params, "state": state,
                                        "opt_state": opt}, 0.5)
    cfg = port_cfg(jcfg)
    sd, measure, adam = load_checkpoint(str(tmp_path), cfg,
                                        with_opt_state=True)
    assert measure == 0.5 and adam.count == 2
    port = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge)
    port.load_state_dict(sd)
    for name, v in jax_leaves(params).items():
        np.testing.assert_array_equal(port.get_parameter(name).detach().numpy(),
                                      v, err_msg=name)
    names = jax_leaf_names(cfg)[0]
    for moments, mine in ((opt[-1].mu, adam.mu), (opt[-1].nu, adam.nu)):
        leaves = jax_leaves(moments)
        for name, t in zip(names, mine):
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(leaves[name], np.float32),
                                          err_msg=name)


@pytest.mark.parametrize("override", [
    dict(entity_sharded="gather"), dict(entity_sharded="boundary"),
    dict(entity_sharded="ring")])
def test_unported_rgcn_configurations_raise(toy_cfg, override):
    """Without a mesh (or, for RGAT, on ring and boundary) the ValueError
    the JAX package raises for the same configuration
    (tests/test_torch_entity_sharding.py runs the schedules on a mesh)."""
    from kgc_gcn_tpu.models import build_model as jax_build_model
    jcfg = rgcn_cfg(toy_cfg, **override)
    with pytest.raises(ValueError) as jax_err:
        jax_build_model(jcfg, 12, 4, 40)
    with pytest.raises(ValueError) as err:
        build_model(port_cfg(jcfg), 12, 4, 40)
    for words in ("gather' only", "needs a (data, graph) mesh"):
        assert (words in str(err.value)) == (words in str(jax_err.value))


def test_cli_trains_rgcn_on_negatives_then_serves(tmp_path, caplog, capsys):
    """``--model rgcn --decoder distmult --num_bases 3 --train_mode
    negative_sampling --device cpu`` trains and writes last.ckpt;
    ``--do_test`` reports the metrics the JAX package computes from that
    checkpoint, and ``--do_predict`` answers from it."""
    data_dir, exp = str(tmp_path / "data"), str(tmp_path / "exp")
    write_toy(data_dir, "Toy")
    base = ["--dataset", "Toy", "--data_dir", data_dir, "--device", "cpu"]
    model = ["--model", "rgcn", "--decoder", "distmult", "--num_bases", "3",
             "--gcn_in_dim", "16", "--gcn_out_dim", "32"]
    assert cli.main(base + model + [
        "--do_train", "--train_mode", "negative_sampling", "--max_epoch", "2",
        "--num_negatives", "8", "--experiments_dir", exp]) == 0
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
    assert (jcfg.model, jcfg.num_bases, jcfg.gcn_out_dim) == ("rgcn", 3, 32)
    ds = jax_load_dataset("Toy", data_dir)
    graph = jax_build_graph(ds.train_triples, ds.num_entity, ds.num_relation)
    jmodel = jax_build_model(jcfg, ds.num_entity, ds.num_relation, ds.num_edge)
    params, state = jmodel.init(jax.random.PRNGKey(0))
    tree, _ = jax_load_checkpoint(str(run), {
        "params": params, "state": state,
        "opt_state": make_optimizer(jcfg).init(params)})
    want = JaxTrainer(jcfg, jmodel, graph, jax_make_banks(ds)).evaluate(
        tree["params"], tree["state"], "test", mark="Test")
    for k, v in want.items():
        assert float(got[k]) == pytest.approx(v, abs=1e-3), k   # log: 3 digits

    qf = tmp_path / "q.txt"
    qf.write_text("e0\tr1\ne3\tr0\n")
    capsys.readouterr()
    assert cli.main(base + ["--do_predict", "--predict_file", str(qf),
                            "--top_k", "3", "--restore_dir", str(run),
                            "--experiments_dir", str(tmp_path / "p")]) == 0
    answers = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(a["subject"], len(a["topk"])) for a in answers] == [("e0", 3),
                                                                ("e3", 3)]
