"""R-GCN's block mode (``num_blocks`` > 0; kgc_gcn_torch/ops/block.py,
models/rgcn.py, convert.py) against the JAX package's
(``kgc_gcn_tpu/models/rgcn.py:_block_aggregate``, its edge-chunked
``lax.scan``): the leaf map, the encoder and its gradients, one training
step's gradients and BN statistics in both train modes, a three-epoch
trajectory, checkpoints both ways and the divisibility error.

The toy graph with d_in 8, d_out 16 and B = 2 or 4 blocks; weights come
from the JAX model's init with randomized BN and entity bias and cross
through convert.py.  Dropout is off.  Tolerance 1e-5 (rtol, and atol
relative to the largest element): float32 products summed in another
order.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kgc_gcn_tpu.models import build_model as jax_build_model
from kgc_gcn_tpu.train import loop as jloop
from kgc_gcn_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from kgc_gcn_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from kgc_gcn_tpu.train.negative import NegativeSamplingTrainer as JaxNegTrainer
from kgc_gcn_tpu.train.optim import make_optimizer

from kgc_gcn_torch.convert import jax_leaf_names, params_to_numpy
from kgc_gcn_torch.models import build_model
from kgc_gcn_torch.ops import block
from kgc_gcn_torch.ops.kernels import PLAIN
from kgc_gcn_torch.train import loop as ploop
from kgc_gcn_torch.train.checkpoint import load_checkpoint, save_checkpoint
from kgc_gcn_torch.train.negative import NegativeSamplingTrainer
from test_torch_common import (
    jax_and_port_models, jax_leaves, port_cfg, port_toy, rgcn_cfg)

TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def block_cfg(toy_cfg, **kw):
    return rgcn_cfg(toy_cfg, **{"num_bases": 0, "num_blocks": 2, **kw})


def close(got, want, rtol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("layers", [1, 2])
def test_block_leaf_names_pin_the_flatten_order(toy, toy_cfg, layers):
    cfg = block_cfg(toy_cfg, num_layers=layers, num_blocks=4)
    ds, graph, _ = toy
    params, _ = jax_build_model(cfg, ds.num_entity, ds.num_relation,
                                ds.num_edge).init(jax.random.PRNGKey(0))
    names = jax_leaf_names(port_cfg(cfg))[0]
    assert list(jax_leaves(params)) == names
    assert len(names) == 3 + 2 * layers
    port = build_model(port_cfg(cfg), ds.num_entity, ds.num_relation,
                       ds.num_edge)
    assert port.mode == "block" and port.nb == 4
    for name, v in jax_leaves(params).items():
        assert tuple(port.get_parameter(name).shape) == v.shape, name
    assert port.layers[0].blocks.shape == (2 * ds.num_relation, 4, 2, 4)


@pytest.mark.parametrize("chunk_bytes", [block.BLOCK_CHUNK_BYTES, 3 * 128],
                         ids=["one_chunk", "chunks_of_3"])
@pytest.mark.parametrize("layers", [1, 2])
def test_block_encode_and_grads_match_jax(toy, toy_cfg, monkeypatch, layers,
                                          chunk_bytes):
    """all_ent and the gradient of every encoder parameter of a weighted sum
    of all_ent and all_rel against JAX ``RGCN.encode``, in one chunk and in
    chunks of 3 edges (128 bytes of blocks an edge at B 2)."""
    monkeypatch.setattr(block, "BLOCK_CHUNK_BYTES", chunk_bytes)
    cfg = block_cfg(toy_cfg, num_layers=layers)
    model, params, state, port = jax_and_port_models(toy, cfg, seed=layers)
    _, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    if chunk_bytes < block.BLOCK_CHUNK_BYTES:
        assert block.block_chunk(port.layers[0].blocks) == 3
    rng = np.random.default_rng(7)
    w_ent = rng.normal(size=(jgraph.n_ent, 16)).astype(np.float32)
    w_rel = rng.normal(size=(2 * jgraph.n_rel, 16)).astype(np.float32)

    def f(p):
        ent, rel, _ = model.encode(p, state, jgraph)
        return jnp.sum(ent * w_ent) + jnp.sum(rel * w_rel), ent
    (_, want_ent), grads = jax.value_and_grad(f, has_aux=True)(params)
    want = jax_leaves(grads)
    ent, rel = port.encode(pgraph)
    ((ent * torch.from_numpy(w_ent)).sum()
     + (rel * torch.from_numpy(w_rel)).sum()).backward()
    close(ent.detach(), want_ent, TOL, "all_ent")
    for name in jax_leaf_names(port.cfg)[0]:
        if name != "decoder.ent_bias":
            close(port.get_parameter(name).grad, want[name], GRAD_RTOL, name)
    # the plain bundle gives the same encode on the CPU
    ent_plain, _ = port.encode(pgraph, kernels=PLAIN)
    torch.testing.assert_close(ent_plain, ent.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("layers", [1, 2])
def test_block_one_vs_all_step_matches_jax(toy, toy_cfg, layers):
    """1-vs-all with ConvE: the loss, every gradient and the decoder's new
    BN statistics of one step against JAX ``Trainer._train_step`` with an
    identity optimizer (grad = (p - new) / lr); first the eval logits
    against JAX's ``decode``."""
    lr = 1e4
    cfg = block_cfg(toy_cfg, num_layers=layers, decoder="conve",
                    gcn_out_dim=32, k_w=4, k_h=8, loss_impl="sparse",
                    hidden_drop=0.0, feat_drop=0.0, batch_size=4)
    model, params, state, port = jax_and_port_models(toy, cfg, seed=3)
    _, jgraph, jbanks = toy
    _, pgraph, pbanks = port_toy()
    bank = jbanks["train"]
    idx = np.array([5, 2, 7, 0])                 # the last row is padding
    mask = np.array([1, 1, 1, 0], np.float32)
    q, li = np.asarray(bank.queries)[idx], np.asarray(bank.label_idx)[idx]
    # eval logits on the randomized BN statistics, against JAX's decode
    ent, rel, _ = model.encode(params, state, jgraph)
    j_logits, _ = model.decode(params, state, ent, rel, jnp.asarray(q[:, 0]),
                               jnp.asarray(q[:, 1]))
    with torch.no_grad():
        pent, prel = port.encode(pgraph)
        logits = port.decode(pent, prel, torch.from_numpy(q[:, 0]),
                             torch.from_numpy(q[:, 1]))
    close(logits, j_logits, TOL, "logits")
    p0 = {k: np.array(v, copy=True) for k, v in jax_leaves(params).items()}
    trainer = jloop.Trainer(cfg, model, jgraph, jbanks)
    trainer.tx = optax.identity()
    new_p, new_s, _, j_loss = trainer._train_step_jit(
        params, state, trainer.tx.init(params), jgraph, jnp.float32(lr),
        jnp.asarray(q), jnp.asarray(li), jnp.asarray(mask),
        jax.random.PRNGKey(0))
    want = {k: (p0[k].astype(np.float64) - v.astype(np.float64)) / lr
            for k, v in jax_leaves(new_p).items()}
    ptr = ploop.Trainer(port_cfg(cfg), port, pgraph, pbanks)
    loss = ptr.loss(*(torch.from_numpy(a) for a in (q, li, mask)))
    grads = torch.autograd.grad(loss, ptr.params)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    for name, g in zip(jax_leaf_names(port.cfg)[0], grads):
        if name in ("decoder.bn0.bias", "decoder.fc_b"):   # degenerate: ~0
            assert max(np.abs(g.numpy()).max(),
                       np.abs(want[name]).max()) < 1e-5, name
            continue
        np.testing.assert_allclose(
            g.numpy(), want[name], rtol=2e-4,
            atol=max(1e-7, 2e-5 * np.abs(want[name]).max()), err_msg=name)
    got_state = params_to_numpy(port, port.cfg)[1]
    for name, v in jax_leaves(new_s).items():
        np.testing.assert_allclose(got_state[name], v, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("layers", [1, 2])
def test_block_negative_step_gradients_match_jax(toy, toy_cfg, monkeypatch,
                                                 layers):
    """Negative sampling with DistMult: loss and gradients of one step
    against the JAX trainer's ``_neg_loss_and_update`` (identity optimizer,
    its negatives replaced by ours)."""
    lr = 1e3
    cfg = block_cfg(toy_cfg, num_layers=layers,
                    train_mode="negative_sampling")
    model, params, state, port = jax_and_port_models(toy, cfg, seed=6)
    _, jgraph, jbanks = toy
    _, pgraph, pbanks = port_toy()
    rng = np.random.default_rng(4)
    idx = rng.permutation(2 * jgraph.n_edge)[:8]
    mask = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    neg = rng.integers(0, jgraph.n_ent, size=(8, cfg.num_negatives))
    jtr = JaxNegTrainer(cfg, model, jgraph, jbanks)
    jtr.tx = optax.identity()
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(neg, jnp.int32))
    p0 = {k: np.array(v, copy=True) for k, v in jax_leaves(params).items()}
    new_p, _, _, j_loss = jtr._neg_loss_and_update(
        params, state, jtr.tx.init(params), jgraph, jnp.float32(lr),
        jtr.pos_triples[idx], jnp.asarray(mask), jax.random.PRNGKey(0))
    want = {k: (p0[k].astype(np.float64) - v.astype(np.float64)) / lr
            for k, v in jax_leaves(new_p).items()}
    ptr = NegativeSamplingTrainer(port_cfg(cfg), port, pgraph, pbanks)
    loss = ptr.loss(ptr.pos_triples[torch.from_numpy(idx)],
                    torch.from_numpy(mask), torch.from_numpy(neg))
    grads = torch.autograd.grad(loss, ptr.params)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    for name, g in zip(jax_leaf_names(port.cfg)[0], grads):
        np.testing.assert_allclose(
            g.numpy(), want[name], rtol=GRAD_RTOL,
            atol=max(1e-8, GRAD_ATOL * np.abs(want[name]).max()), err_msg=name)
    assert np.abs(want["layers.0.blocks"]).max() > 0


def test_block_three_epoch_trajectory_matches_jax(toy, toy_cfg, tmp_path):
    """3 epochs of 1-vs-all DistMult through both packages'
    ``train_and_evaluate`` with one seed: losses, Val metrics and the final
    parameters.  StepLR fires after epoch 2."""
    cfg = block_cfg(toy_cfg, batch_size=8, lr_step_size=2, lr_gamma=0.9,
                    learning_rate=5e-3, max_epoch=3, eval_every=1,
                    loss_impl="sparse")
    model, params, state, port = jax_and_port_models(toy, cfg, seed=4)
    _, jgraph, jbanks = toy
    _, pgraph, pbanks = port_toy()
    jp, _, _, jbest = jloop.train_and_evaluate(
        jloop.Trainer(cfg, model, jgraph, jbanks), params, state,
        make_optimizer(cfg).init(params), model_dir=str(tmp_path), seed=11)
    (tmp_path / "port").mkdir()
    pbest = ploop.train_and_evaluate(
        ploop.Trainer(port_cfg(cfg), port, pgraph, pbanks),
        model_dir=str(tmp_path / "port"), seed=11)
    read = lambda p: [json.loads(x) for x in p.read_text().splitlines()][1:]
    for g, w in zip(read(tmp_path / "port" / "metrics.jsonl"),
                    read(tmp_path / "metrics.jsonl")):
        assert g["epoch"] == w["epoch"]
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-4, abs=2e-6)
        for k, v in w["val"].items():
            assert g["val"][k] == pytest.approx(v, abs=1e-3), (g["epoch"], k)
    assert pbest == pytest.approx(jbest, abs=1e-3)
    for name, v in jax_leaves(jp).items():
        close(port.get_parameter(name).detach(), v, 1e-4, name)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_block_checkpoints_cross_both_ways(toy, toy_cfg, tmp_path, direction):
    """A 2-layer block model's parameters and Adam moments, written by one
    package and read by the other."""
    ds, _, _ = toy
    cfg = block_cfg(toy_cfg, num_layers=2, train_mode="negative_sampling")
    pcfg = port_cfg(cfg)
    jmodel = jax_build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge)
    params, state = jmodel.init(jax.random.PRNGKey(1))
    tx = make_optimizer(cfg)
    names = jax_leaf_names(pcfg)[0]
    if direction == "port_to_jax":
        _, pgraph, pbanks = port_toy()
        port = build_model(pcfg, ds.num_entity, ds.num_relation, ds.num_edge)
        trainer = NegativeSamplingTrainer(pcfg, port, pgraph, pbanks)
        for s in range(2):
            trainer.train_step(1e-2, *trainer.batch(
                torch.arange(8 * s, 8 * s + 8), torch.ones(8)))
        save_checkpoint(str(tmp_path), port, trainer.opt_state, pcfg, 0.25)
        tree, measure = jax_load_checkpoint(str(tmp_path), {
            "params": params, "state": state, "opt_state": tx.init(params)})
        assert measure == 0.25
        ours = params_to_numpy(port, pcfg)[0]
        adam, mine = tree["opt_state"][-1], trainer.opt_state
        assert int(adam.count) == mine.count == 2
        for name, v in jax_leaves(tree["params"]).items():
            np.testing.assert_array_equal(v, ours[name], err_msg=name)
        for moments, got in ((adam.mu, mine.mu), (adam.nu, mine.nu)):
            for name, t in zip(names, got):
                np.testing.assert_array_equal(
                    np.asarray(jax_leaves(moments)[name]), t.numpy(), name)
        return
    opt = tx.init(params)
    rng = np.random.default_rng(9)
    for _ in range(2):
        g = jax.tree.map(lambda p: jnp.asarray(
            rng.normal(size=p.shape).astype(np.float32)), params)
        upd, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, upd)
    jax_save_checkpoint(str(tmp_path), {"params": params, "state": state,
                                        "opt_state": opt}, 0.5)
    sd, measure, adam = load_checkpoint(str(tmp_path), pcfg,
                                        with_opt_state=True)
    port = build_model(pcfg, ds.num_entity, ds.num_relation, ds.num_edge)
    port.load_state_dict(sd)
    assert measure == 0.5 and adam.count == 2
    for name, v in jax_leaves(params).items():
        np.testing.assert_array_equal(
            port.get_parameter(name).detach().numpy(), v, err_msg=name)
    for moments, got in ((opt[-1].mu, adam.mu), (opt[-1].nu, adam.nu)):
        for name, t in zip(names, got):
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(jax_leaves(moments)[name]), name)


@pytest.mark.parametrize("layers,nb", [(1, 3), (2, 16)])
def test_block_divisibility_error_matches_jax(toy, toy_cfg, layers, nb):
    """B must divide every layer's d_in and d_out (8 -> 16 -> 16): both
    packages refuse B 3 and B 16 with the same message."""
    ds, _, _ = toy
    cfg = block_cfg(toy_cfg, num_layers=layers, num_blocks=nb)
    with pytest.raises(ValueError) as want:
        jax_build_model(cfg, ds.num_entity, ds.num_relation,
                        ds.num_edge).init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as got:
        build_model(port_cfg(cfg), ds.num_entity, ds.num_relation,
                    ds.num_edge)
    assert str(got.value) == str(want.value)
    assert "must divide dims" in str(got.value)
