"""Every decoder on every model family in the port against the JAX package
(kgc_gcn_torch/models/{decoders,family_base,__init__}.py and the loss choice
of train/loop.py): 1-vs-all logits, the query trunk and the candidate scores
of ConvE, DistMult, TransE, ComplEx and RotatE on MGCN, R-GCN and RGAT; one
1-vs-all step of three decoders and a negative-sampling step; the dense fallback
of the trunkless decoders and the refusal of an odd width.

The toy graph with d_in 8 and d_out 32 (ConvE 4 x 8, 4 filters 3 x 3; R-GCN
3 bases; RGAT 4 heads); weights come from the JAX model's init with
randomized BN statistics, entity bias and RGAT attention bias, carried
across by convert.py.  Dropout is off: the two random streams differ.
Tolerances: logits, trunks and candidate scores 1e-4 (rtol, and atol
relative to the largest element: an encode and a decoder of float32 sums in
another order); one step's loss rtol 1e-5 and gradients ``GRAD_RTOL`` with
its floor, BN statistics rtol 1e-5 / atol 1e-6 (tests/test_torch_train.py).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kgc_gcn_tpu.models import build_model as jax_build_model
from kgc_gcn_tpu.models.decoders import DECODERS as JAX_DECODERS
from kgc_gcn_tpu.train import loop as jloop
from kgc_gcn_tpu.train.negative import NegativeSamplingTrainer as JaxNegTrainer

from kgc_gcn_torch.convert import jax_leaf_names, params_to_numpy
from kgc_gcn_torch.models import build_model
from kgc_gcn_torch.models.decoders import DECODERS, build_decoder
from kgc_gcn_torch.train import loop as ploop
from kgc_gcn_torch.train.negative import NegativeSamplingTrainer
from test_torch_common import jax_and_port_models, jax_leaves, port_cfg, port_toy

LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL, GRAD_FLOOR = 2e-4, 2e-5, 1e-7
BN_TOL = dict(rtol=1e-5, atol=1e-6)
# ConvE's directions that BatchNorm cancels (tests/test_torch_train.py;
# bn0's scale up to BN1's eps, as chip_smoke.py's DEGENERATE has it): their
# true gradient is ~0 and both packages leave float noise there, so their
# absolute tolerance is relative to the step's largest gradient
DEGENERATE = ("decoder.bn0.bias", "decoder.bn0.scale", "decoder.fc_b")
FAMILIES = ("mgcn", "rgcn", "rgat")
TRUNKS = ("conve", "distmult", "complex")


def dec_cfg(toy_cfg, model, decoder, **kw):
    """A toy config of one family and decoder, dropout off."""
    return toy_cfg.replace(model=model, decoder=decoder, num_bases=3,
                           num_heads=4, gcn_drop=0.0, conv_drop=0.0,
                           feat_drop=0.0, hidden_drop=0.0, **kw)


def close(got, want, rtol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def close_grads(grads, want, names):
    g_max = max(np.abs(v).max() for v in want.values())
    for name, g in zip(names, grads):
        scale = g_max if name in DEGENERATE else np.abs(want[name]).max()
        np.testing.assert_allclose(
            g.numpy(), want[name], rtol=GRAD_RTOL,
            atol=max(GRAD_FLOOR, GRAD_ATOL * scale), err_msg=name)


def test_the_registry_names_the_jax_decoders():
    assert list(DECODERS) == list(JAX_DECODERS)
    assert {k for k, d in DECODERS.items() if d.has_trunk} == set(TRUNKS)


@pytest.mark.parametrize("decoder", list(DECODERS))
@pytest.mark.parametrize("model", FAMILIES)
def test_decoder_on_family_matches_jax(toy, toy_cfg, model, decoder):
    """Eval-mode logits, candidate scores and (where the decoder has one)
    the query trunk and its bias, against the JAX family's ``decode``,
    ``score_candidates`` and ``query_and_bias``."""
    cfg = dec_cfg(toy_cfg, model, decoder)
    jmodel, params, state, port = jax_and_port_models(toy, cfg, seed=11)
    assert type(port.decoder) is DECODERS[decoder]
    _, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    rng = np.random.default_rng(12)
    src = rng.integers(0, jgraph.n_ent, size=6)
    rel = rng.integers(0, 2 * jgraph.n_rel, size=6)
    cand = rng.integers(0, jgraph.n_ent, size=(6, 5))
    ent, rel_out, _ = jmodel.encode(params, state, jgraph, train=False)
    js, jr = jnp.asarray(src), jnp.asarray(rel)
    want, _ = jmodel.decode(params, state, ent, rel_out, js, jr, train=False)
    want_c, _ = jmodel.score_candidates(params, state, ent, rel_out, js, jr,
                                        jnp.asarray(cand), train=False)
    t = lambda a: torch.from_numpy(np.asarray(a))
    with torch.no_grad():
        pent, prel = port.encode(pgraph)
        got = port.decode(pent, prel, t(src), t(rel))
        got_c = port.score_candidates(pent, prel, t(src), t(rel), t(cand))
    close(got, want, LOGIT_TOL, "logits")
    close(got_c, want_c, LOGIT_TOL, "candidate scores")
    # a candidate scores as its column of the 1-vs-all logits
    torch.testing.assert_close(got_c, torch.gather(got, 1, t(cand)),
                               rtol=1e-5, atol=1e-5 * float(got.abs().max()))
    if decoder in TRUNKS:
        want_h, want_b, _ = jmodel.query_and_bias(params, state, ent, rel_out,
                                                  js, jr, train=False)
        with torch.no_grad():
            h, bias = port.query_and_bias(pent, prel, t(src), t(rel))
        close(h, want_h, LOGIT_TOL, "trunk")
        close(bias.detach(), want_b, 0.0, "ent_bias")


def _jax_step(trainer, params, state, lr, *batch):
    """One JAX step with an identity optimizer: (loss, gradients, new
    state), grad = (p - new) / lr."""
    p0 = {k: np.array(v, copy=True) for k, v in jax_leaves(params).items()}
    trainer.tx = optax.identity()
    step = (jax.jit(trainer._neg_loss_and_update)
            if isinstance(trainer, JaxNegTrainer) else trainer._train_step_jit)
    new_p, new_s, _, loss = step(params, state, trainer.tx.init(params),
                                 trainer.graph, jnp.float32(lr), *batch,
                                 jax.random.PRNGKey(0))
    grads = {k: (p0[k].astype(np.float64) - v.astype(np.float64)) / lr
             for k, v in jax_leaves(new_p).items()}
    return float(loss), grads, jax_leaves(new_s)


@pytest.mark.parametrize("model,decoder,impl", [
    ("mgcn", "transe", "auto"), ("mgcn", "complex", "fused"),
    ("rgcn", "conve", "sparse")])
def test_one_vs_all_step_matches_jax(toy, toy_cfg, model, decoder, impl):
    """Loss, every gradient and the BN statistics of one 1-vs-all step
    against JAX ``Trainer._train_step``: TransE through the dense loss (no
    trunk), ComplEx through the fused loss (K2a/K2b's plain versions),
    ConvE on another family (its BN statistics in R-GCN's decoder)."""
    cfg = dec_cfg(toy_cfg, model, decoder, loss_impl=impl, lbl_smooth=0.1)
    jmodel, params, state, port = jax_and_port_models(toy, cfg, seed=13)
    _, jgraph, jbanks = toy
    _, pgraph, pbanks = port_toy()
    bank = jbanks["train"]
    idx = np.array([5, 2, 7, 0])                 # the last row is padding
    mask = np.array([1, 1, 1, 0], np.float32)
    q, li = np.asarray(bank.queries)[idx], np.asarray(bank.label_idx)[idx]
    jtr = jloop.Trainer(cfg, jmodel, jgraph, jbanks)
    ptr = ploop.Trainer(port_cfg(cfg), port, pgraph, pbanks)
    assert ptr.loss_impl == jtr.loss_impl
    j_loss, want, want_state = _jax_step(jtr, params, state, 1e4,
                                         jnp.asarray(q), jnp.asarray(li),
                                         jnp.asarray(mask))
    loss = ptr.loss(*(torch.from_numpy(a) for a in (q, li, mask)))
    grads = torch.autograd.grad(loss, ptr.params)
    np.testing.assert_allclose(float(loss.detach()), j_loss, rtol=LOSS_RTOL)
    close_grads(grads, want, jax_leaf_names(port.cfg)[0])
    got_state = params_to_numpy(port, port.cfg)[1]
    assert sorted(got_state) == sorted(want_state)
    for name, v in want_state.items():
        np.testing.assert_allclose(got_state[name], v, err_msg=name, **BN_TOL)


def test_negative_step_matches_jax(toy, toy_cfg, monkeypatch):
    """Loss and every gradient of one negative-sampling step (BCE over the
    true object and 5 negatives) of R-GCN + RotatE, whose candidate scorer
    is TransE's distance on the rotated subject, against the JAX trainer's
    ``_neg_loss_and_update``, with its negative draw replaced by ours (the
    trunk scorers' steps: tests/test_torch_negative.py; every scorer's
    values: ``test_decoder_on_family_matches_jax``)."""
    cfg = dec_cfg(toy_cfg, "rgcn", "rotate", train_mode="negative_sampling",
                  num_negatives=5, batch_size=8)
    jmodel, params, state, port = jax_and_port_models(toy, cfg, seed=14)
    _, jgraph, jbanks = toy
    _, pgraph, pbanks = port_toy()
    rng = np.random.default_rng(15)
    idx = rng.permutation(2 * jgraph.n_edge)[:8]
    mask = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    neg = rng.integers(0, jgraph.n_ent, size=(8, cfg.num_negatives))
    jtr = JaxNegTrainer(cfg, jmodel, jgraph, jbanks)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(neg, jnp.int32))
    j_loss, want, _ = _jax_step(jtr, params, state, 1e3,
                                jtr.pos_triples[idx], jnp.asarray(mask))
    ptr = NegativeSamplingTrainer(port_cfg(cfg), port, pgraph, pbanks)
    loss = ptr.loss(ptr.pos_triples[torch.from_numpy(idx)],
                    torch.from_numpy(mask), torch.from_numpy(neg))
    grads = torch.autograd.grad(loss, ptr.params)
    np.testing.assert_allclose(float(loss.detach()), j_loss, rtol=LOSS_RTOL)
    close_grads(grads, want, jax_leaf_names(port.cfg)[0])
    assert np.abs(want["entity_embedding"]).max() > 0


@pytest.mark.parametrize("impl", ["auto", "sparse", "fused", "dense"])
@pytest.mark.parametrize("decoder", list(DECODERS))
def test_loss_choice_matches_jax(toy, toy_cfg, caplog, decoder, impl):
    """The loss each decoder trains with: TransE and RotatE (no trunk) fall
    back to the dense loss, with the JAX warning when sparse or fused was
    asked for and silently under auto."""
    cfg = dec_cfg(toy_cfg, "rgcn", decoder, loss_impl=impl)
    ds, jgraph, jbanks = toy
    jmodel = jax_build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge)
    port = build_model(port_cfg(cfg), ds.num_entity, ds.num_relation,
                       ds.num_edge)
    with caplog.at_level(logging.WARNING):
        want = jloop.Trainer(cfg, jmodel, jgraph, jbanks).loss_impl
        want_log = [r.getMessage() for r in caplog.records]
        caplog.clear()
        _, pgraph, pbanks = port_toy()
        got = ploop.Trainer(port_cfg(cfg), port, pgraph, pbanks).loss_impl
        got_log = [r.getMessage() for r in caplog.records]
    assert got == want
    fallback = decoder not in TRUNKS and impl in ("sparse", "fused")
    assert got == ("dense" if decoder not in TRUNKS or impl == "dense"
                   else "sparse" if impl == "auto" else impl)
    assert got_log == want_log and bool(got_log) == fallback
    if fallback:
        assert f"loss_impl={impl} requires a decoder" in got_log[0]


@pytest.mark.parametrize("decoder", ["complex", "rotate"])
def test_odd_width_is_refused_with_the_jax_text(toy_cfg, decoder):
    cfg = toy_cfg.replace(decoder=decoder, gcn_out_dim=15)
    with pytest.raises(ValueError) as want:
        JAX_DECODERS[decoder][0](jax.random.PRNGKey(0), cfg, 12)
    with pytest.raises(ValueError) as got:
        build_decoder(port_cfg(cfg), 12, torch.Generator())
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="even gcn_out_dim"):
        build_model(port_cfg(cfg).replace(model="rgcn"), 12, 4, 40)
