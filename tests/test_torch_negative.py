"""Negative-sampling training in the port against the JAX package
(kgc_gcn_torch/train/negative.py, ops/losses.py, the families'
``score_candidates``): the objectives, the positives, one step's loss and
gradients with injected negatives, and a 3-epoch trajectory through
``train_and_evaluate`` against a JAX loop built from the package's public
pieces, with the same batches and negatives.

The two packages draw negatives from different generators (jax.random
against torch.Generator), so the tests hand both the same numpy-drawn
negatives.  Dropout is off.  Tolerances: 1e-5 (float32 sums in another
order); gradients with the absolute part relative to each tensor's largest.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kgc_gcn_tpu.ops.losses as jl
from kgc_gcn_tpu.data.batching import epoch_batches as jax_epoch_batches
from kgc_gcn_tpu.models.decoders import conve_score_candidates
from kgc_gcn_tpu.train import loop as jloop
from kgc_gcn_tpu.train.negative import NegativeSamplingTrainer as JaxNegTrainer
from kgc_gcn_tpu.train.optim import apply_updates_with_lr, make_optimizer
from kgc_gcn_tpu.train.optim import epoch_lr as jax_epoch_lr

import kgc_gcn_torch.ops.losses as pl
from kgc_gcn_torch.convert import jax_leaf_names
from kgc_gcn_torch.train import loop as ploop
from kgc_gcn_torch.train.negative import NegativeSamplingTrainer
from test_torch_common import (
    jax_and_port_models, jax_leaves, port_cfg, port_toy, rgcn_cfg)

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _scores(seed=0, b=6, k=5):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=b).astype(np.float32)
    neg = rng.normal(size=(b, k)).astype(np.float32)
    mask = np.ones(b, np.float32)
    mask[-2:] = 0.0
    return pos, neg, mask


@pytest.mark.parametrize("objective", ["bce", "margin", "self_adversarial"])
def test_sampled_objectives_match_jax(objective):
    """Value and gradients with a row mask (the self-adversarial weights are
    constants in both packages)."""
    pos, neg, mask = _scores()
    fns = {"bce": (lambda p, n, m: jl.sampled_bce_with_logits(p, n, m),
                   lambda p, n, m: pl.sampled_bce_with_logits(p, n, m)),
           "margin": (lambda p, n, m: jl.margin_ranking_loss(p, n, 0.5, m),
                      lambda p, n, m: pl.margin_ranking_loss(p, n, 0.5, m)),
           "self_adversarial": (
               lambda p, n, m: jl.self_adversarial_loss(p, n, 0.5, 2.0, m),
               lambda p, n, m: pl.self_adversarial_loss(p, n, 0.5, 2.0, m))}
    jfn, pfn = fns[objective]
    want, (wp, wn) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(mask))
    tp, tn = (torch.from_numpy(a).requires_grad_() for a in (pos, neg))
    got = pfn(tp, tn, torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(wp), **TOL)
    np.testing.assert_allclose(tn.grad.numpy(), np.asarray(wn), **TOL)
    assert not tn.grad[-2:].any()                     # masked rows


def test_positives_and_epoch_shape_match_jax(toy, toy_cfg):
    cfg = rgcn_cfg(toy_cfg, train_mode="negative_sampling")
    model, params, state, port = jax_and_port_models(toy, cfg)
    _, jgraph, jbanks = toy
    _, pgraph, pbanks = port_toy()
    jtr = JaxNegTrainer(cfg, model, jgraph, jbanks)
    ptr = NegativeSamplingTrainer(port_cfg(cfg), port, pgraph, pbanks)
    np.testing.assert_array_equal(ptr.pos_triples.numpy(),
                                  np.asarray(jtr.pos_triples))
    assert ptr.n_train == 2 * jgraph.n_edge
    assert ptr.steps_per_epoch == jtr.steps_per_epoch == -(-ptr.n_train // 8)
    tri, mask, neg = ptr.batch(torch.arange(8), torch.ones(8))
    assert neg.shape == (8, cfg.num_negatives) and neg.device == ptr.device
    assert 0 <= int(neg.min()) and int(neg.max()) < jgraph.n_ent
    with pytest.raises(ValueError, match="neg_loss"):
        NegativeSamplingTrainer(port_cfg(cfg).replace(neg_loss="hinge"),
                                port, pgraph, pbanks)


def test_conve_candidate_scores_match_jax(toy, toy_cfg):
    """MGCN + ConvE scores sampled candidates as the JAX decoder does (eval
    BN on randomized statistics)."""
    model, params, state, port = jax_and_port_models(toy, toy_cfg, seed=2)
    _, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    ent, rel, _ = model.encode(params, state, jgraph)
    rng = np.random.default_rng(3)
    src, r = rng.integers(0, 12, size=5), rng.integers(0, 8, size=5)
    cand = rng.integers(0, 12, size=(5, 4))
    want, _ = conve_score_candidates(params.decoder, state.decoder, toy_cfg,
                                     ent[src], rel[r], ent[cand],
                                     jnp.asarray(cand), train=False)
    t = lambda a: torch.from_numpy(np.asarray(a))
    with torch.no_grad():
        pent, prel = port.encode(pgraph)
        got = port.score_candidates(pent, prel, t(src), t(r), t(cand))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("neg_loss", ["bce", "margin", "self_adversarial"])
def test_negative_step_gradients_match_jax(toy, toy_cfg, monkeypatch,
                                           neg_loss):
    """Loss and every parameter's gradient of one step against the JAX
    trainer's ``_neg_loss_and_update`` with an identity optimizer
    (grad = (p - new) / lr) and its negative draw replaced by ours."""
    lr = 1e3
    cfg = rgcn_cfg(toy_cfg, train_mode="negative_sampling", neg_loss=neg_loss,
                   neg_margin=0.5, neg_adversarial_temp=2.0, num_layers=2)
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
    names = jax_leaf_names(port.cfg)[0]
    assert len(names) == len(grads) == 9
    for name, g in zip(names, grads):
        np.testing.assert_allclose(
            g.numpy(), want[name], rtol=GRAD_RTOL,
            atol=max(1e-8, GRAD_ATOL * np.abs(want[name]).max()), err_msg=name)
    assert np.abs(want["layers.0.coeff"]).max() > 0


def test_three_epoch_trajectory_matches_a_jax_loop(toy, toy_cfg, tmp_path):
    """3 epochs of the port's ``train_and_evaluate`` (negatives injected
    through ``batch``) against a JAX loop over the same batch plan and
    negatives, built from ``encode``, ``score_candidates``, the sampled
    BCE, ``make_optimizer`` and ``apply_updates_with_lr``: per-epoch mean
    losses, Val metrics and final parameters.  StepLR fires after epoch 2."""
    seed, epochs = 13, 3
    cfg = rgcn_cfg(toy_cfg, train_mode="negative_sampling", max_epoch=epochs,
                   eval_every=1, learning_rate=0.01, lr_step_size=2,
                   lr_gamma=0.5)
    model, params, state, port = jax_and_port_models(toy, cfg, seed=8)
    _, jgraph, jbanks = toy
    _, pgraph, pbanks = port_toy()
    ptr = NegativeSamplingTrainer(port_cfg(cfg), port, pgraph, pbanks)
    n_pos, bsz, k = ptr.n_train, cfg.batch_size, cfg.num_negatives
    steps = -(-n_pos // bsz)
    negs = np.random.default_rng(5).integers(
        0, jgraph.n_ent, size=(epochs * steps, bsz, k))

    # JAX side
    pos = JaxNegTrainer(cfg, model, jgraph, jbanks).pos_triples
    tx = make_optimizer(cfg)
    opt = tx.init(params)

    def loss_fn(p, tri, mask, neg):
        ent, rel, _ = model.encode(p, state, jgraph, train=True, rngs={})
        cand = jnp.concatenate([tri[:, 2:3], neg], axis=1)
        logits, _ = model.score_candidates(p, state, ent, rel, tri[:, 0],
                                           tri[:, 1], cand, train=True)
        return jl.sampled_bce_with_logits(logits[:, 0], logits[:, 1:], mask)

    @jax.jit
    def step(p, o, tri, mask, neg, lr):
        loss, g = jax.value_and_grad(loss_fn)(p, tri, mask, neg)
        upd, o = tx.update(g, o, p)
        return apply_updates_with_lr(p, upd, lr), o, loss

    jtr = jloop.Trainer(cfg, model, jgraph, jbanks)
    host_rng = np.random.default_rng(seed)
    want = []
    for epoch in range(1, epochs + 1):
        idx, mask = jax_epoch_batches(n_pos, bsz, host_rng)
        losses = []
        for s in range(steps):
            params, opt, loss = step(
                params, opt, pos[idx[s]], jnp.asarray(mask[s]),
                jnp.asarray(negs[(epoch - 1) * steps + s], jnp.int32),
                jnp.float32(jax_epoch_lr(cfg, epoch)))
            losses.append(float(loss))
        want.append((np.mean(losses), jtr.evaluate(params, state, "valid")))

    # port side: the same negatives, in order, through ``batch``
    it = iter(torch.from_numpy(negs))
    ptr.batch = lambda idx, mask: (ptr.pos_triples[idx], mask, next(it))
    ploop.train_and_evaluate(ptr, model_dir=str(tmp_path), seed=seed)
    recs = [json.loads(x) for x in
            (tmp_path / "metrics.jsonl").read_text().splitlines()][1:]
    assert [r["epoch"] for r in recs] == [1, 2, 3]
    for rec, (loss, val) in zip(recs, want):
        assert rec["loss"] == pytest.approx(loss, rel=1e-4, abs=2e-6)
        for key, v in val.items():
            assert rec["val"][key] == pytest.approx(v, abs=1e-4), key
    for name, v in jax_leaves(params).items():
        got = port.get_parameter(name).detach().numpy()
        np.testing.assert_allclose(got, v, rtol=1e-4,
                                   atol=1e-4 * np.abs(v).max(), err_msg=name)
