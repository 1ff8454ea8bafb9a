"""``--remat`` (kgc_gcn_torch/train/remat.py, ``Trainer.encode_train``): the
1-vs-all trainer's encoder recomputed in the backward, as
``jax.checkpoint`` does in ``kgc_gcn_tpu/train/loop.py:126-132``.

A remat step against the plain step from the same weights, with dropout on
(and MGCN's edge sampling in its own case), for every family and schedule:
the loss, every gradient, the BN statistics, the parameters after one and
two steps and the trainer's generator state must be equal to the bit, and
the encoder must have run twice in the remat step (its recompute).  Then
the port's remat step against JAX's, dropout off, at
tests/test_torch_train.py's tolerances; the negative-sampling trainer
ignores ``remat`` (as JAX's does); ``--remat`` reaches ``cfg.remat``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kgc_gcn_tpu.train import loop as jloop

from kgc_gcn_torch import cli
from kgc_gcn_torch.convert import jax_leaf_names
from kgc_gcn_torch.models import build_model
from kgc_gcn_torch.models.common import BatchNorm, frozen_running_stats
from kgc_gcn_torch.ops import scatter
from kgc_gcn_torch.train import optim
from kgc_gcn_torch.train.loop import Trainer
from kgc_gcn_torch.train.negative import NegativeSamplingTrainer
from test_torch_common import (
    jax_and_port_models, port_cfg, port_toy, rgat_cfg, rgcn_cfg)
from test_torch_train import (
    BN_TOL, DEGENERATE, GRAD_ATOL, GRAD_FLOOR, GRAD_RTOL, NOISE, copy_leaves,
    jax_leaves, no_dropout, port_state)

IDX, MASK = [5, 2, 7, 0], [1.0, 1.0, 1.0, 0.0]   # the last row is padding
LR = 0.01
DROP = dict(gcn_drop=0.3, conv_drop=0.2, hidden_drop=0.3, feat_drop=0.2)

# family (mgcn, rgcn, rgat) and its config's changes; the bf16 case runs
# with KGC_MGCN_CONTRIB=bf16 (the use_pallas path's d_x stream)
CASES = {
    "mgcn_halves": ("mgcn", {}),
    "mgcn_stacked": ("mgcn", dict(spmm_mode="stacked")),
    "mgcn_stacked_xla": ("mgcn", dict(spmm_mode="stacked_xla")),
    "mgcn_ew_pallas": ("mgcn", dict(ew_impl="pallas")),
    "mgcn_2layers_corr": ("mgcn", dict(num_layers=2, composition="corr")),
    "mgcn_sampled": ("mgcn", dict(edge_sample_size=16)),
    "mgcn_contrib_bf16": ("mgcn", dict(use_pallas=True)),
    "rgcn_basis": ("rgcn", {}),
    "rgcn_block": ("rgcn", dict(num_bases=0, num_blocks=4)),
    "rgat": ("rgat", {}),
}


def case_cfg(toy_cfg, name):
    family, kw = CASES[name]
    cfg = {"mgcn": lambda c: c, "rgcn": rgcn_cfg, "rgat": rgat_cfg}[family](
        port_cfg(toy_cfg))
    return cfg.replace(**{**DROP, **kw})


def counted_encodes(model):
    """Counts the model's ``encode`` calls in ``model.encodes``."""
    model.encodes = 0
    encode = model.encode

    def counting(*a, **k):
        model.encodes += 1
        return encode(*a, **k)

    model.encode = counting
    return model


def two_steps(trainer, batch):
    """One step by hand (loss, gradients, Adam) and one ``train_step``; the
    state after each, and the encodes of the first."""
    out = {}
    loss, grads = trainer.gradients(*batch)
    out["encodes"] = trainer.model.encodes
    out["loss"] = loss
    out["grads"] = grads
    optim.step(trainer.params, grads, trainer.opt_state, trainer.cfg, LR,
               trainer.sharded)
    out["params1"] = [p.detach().clone() for p in trainer.params]
    out["buffers1"] = [b.clone() for b in trainer.model.buffers()]
    out["gen1"] = trainer.generator.get_state()
    trainer.train_step(LR, *batch)
    out["params2"] = [p.detach().clone() for p in trainer.params]
    out["buffers2"] = [b.clone() for b in trainer.model.buffers()]
    out["gen2"] = trainer.generator.get_state()
    return out


def assert_bit_equal(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(got, want), (
        f"{what}: max abs err {float((got - want).abs().max()):.3g}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_remat_step_equals_plain_step_to_the_bit(toy_cfg, name,
                                                 monkeypatch):
    if name == "mgcn_contrib_bf16":
        monkeypatch.setattr(scatter, "MGCN_CONTRIB", "bf16")
    cfg = case_cfg(toy_cfg, name)
    ds, graph, banks = port_toy()
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=graph.e_pad)
    bank = banks["train"]
    idx = torch.tensor(IDX)
    batch = (bank.queries[idx], bank.label_idx[idx], torch.tensor(MASK))
    runs = {}
    for remat in (False, True):
        trainer = Trainer(cfg.replace(remat=remat),
                          counted_encodes(copy.deepcopy(model)), graph, banks)
        start = trainer.generator.get_state()
        runs[remat] = two_steps(trainer, batch)
    plain, rem = runs[False], runs[True]
    assert (plain["encodes"], rem["encodes"]) == (1, 2)
    assert not torch.equal(plain["gen1"], start)   # the masks were drawn
    assert_bit_equal(rem["loss"], plain["loss"], "loss")
    names = jax_leaf_names(cfg)[0]
    for n, g, w in zip(names, rem["grads"], plain["grads"]):
        assert_bit_equal(g, w, f"grad {n}")
    for key in ("params1", "buffers1", "params2", "buffers2"):
        for i, (g, w) in enumerate(zip(rem[key], plain[key])):
            assert_bit_equal(g, w, f"{key}[{i}]")
    for key in ("gen1", "gen2"):
        assert torch.equal(rem[key], plain[key]), key
    if cfg.model == "mgcn":   # the encoder's BN statistics moved, once
        assert not torch.equal(rem["buffers1"][0], model.conv.bn.mean)


def test_frozen_running_stats_leave_the_statistics():
    bn = BatchNorm(3)
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    with frozen_running_stats():
        y = bn(x, train=True)
    assert torch.equal(bn.mean, torch.zeros(3))
    assert torch.equal(bn.var, torch.ones(3))
    assert torch.equal(y, bn(x, train=True))   # batch statistics either way
    assert not torch.equal(bn.mean, torch.zeros(3))


def test_decoder_stream_of_a_data_rank_is_not_replayed(toy_cfg):
    """Under a data axis the decoder's sites draw from a second generator:
    the recompute neither draws from it nor resets it."""
    cfg = case_cfg(toy_cfg, "mgcn_halves").replace(remat=True)
    ds, graph, banks = port_toy()
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=graph.e_pad)
    bank = banks["train"]
    idx = torch.tensor(IDX)
    batch = (bank.queries[idx], bank.label_idx[idx], torch.tensor(MASK))
    states = {}
    for remat in (False, True):
        trainer = Trainer(cfg.replace(remat=remat), copy.deepcopy(model),
                          graph, banks)
        trainer.batch_generator = torch.Generator().manual_seed(99)
        trainer.gradients(*batch)
        states[remat] = (trainer.generator.get_state(),
                         trainer.batch_generator.get_state())
    for a, b in zip(states[False], states[True]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", ["mgcn", "rgcn"])
def test_remat_step_matches_jax_remat_step(toy, toy_cfg, family):
    """The port's remat step against JAX ``Trainer(cfg.replace(remat=True))
    ._train_step_jit`` with an identity optimizer (grad = (p - new) / lr),
    dropout off: loss, gradients and the new BN statistics."""
    lr = 1e4
    cfg = no_dropout(toy_cfg, remat=True, lbl_smooth=0.1)
    if family == "rgcn":
        cfg = rgcn_cfg(cfg)
    model, params, state, port = jax_and_port_models(toy, cfg, seed=3)
    _, jgraph, jbanks = toy
    _, pgraph, pbanks = port_toy()
    bank = jbanks["train"]
    q = np.asarray(bank.queries)[IDX]
    li = np.asarray(bank.label_idx)[IDX]
    mask = np.asarray(MASK, np.float32)
    p0 = copy_leaves(params)
    trainer = jloop.Trainer(cfg, model, jgraph, jbanks)
    assert trainer.cfg.remat
    trainer.tx = optax.identity()
    new_p, new_s, _, j_loss = trainer._train_step_jit(
        params, state, trainer.tx.init(params), jgraph, jnp.float32(lr),
        jnp.asarray(q), jnp.asarray(li), jnp.asarray(mask),
        jax.random.PRNGKey(0))
    want = {k: (p0[k].astype(np.float64) - v.astype(np.float64)) / lr
            for k, v in jax_leaves(new_p).items()}

    ptrainer = Trainer(port_cfg(cfg), counted_encodes(port), pgraph, pbanks)
    loss, grads = ptrainer.gradients(
        *(torch.from_numpy(a) for a in (q, li, mask)))
    assert port.encodes == 2
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    for name, g in zip(jax_leaf_names(port.cfg)[0], grads):
        if name in DEGENERATE:
            assert max(np.abs(g.numpy()).max(),
                       np.abs(want[name]).max()) < NOISE
            continue
        np.testing.assert_allclose(
            g.numpy(), want[name], rtol=GRAD_RTOL,
            atol=max(GRAD_FLOOR, GRAD_ATOL * np.abs(want[name]).max()),
            err_msg=name)
    got_state = port_state(port)
    for name, v in jax_leaves(new_s).items():
        np.testing.assert_allclose(got_state[name], v, err_msg=name, **BN_TOL)


def test_negative_sampling_trainer_ignores_remat(toy_cfg):
    """JAX's negative-sampling loss encodes without ``jax.checkpoint``
    (kgc_gcn_tpu/train/negative.py:73-76): so does the port's."""
    cfg = case_cfg(toy_cfg, "rgcn_basis").replace(
        train_mode="negative_sampling")
    ds, graph, banks = port_toy()
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=graph.e_pad)
    out = {}
    for remat in (False, True):
        trainer = NegativeSamplingTrainer(
            cfg.replace(remat=remat), counted_encodes(copy.deepcopy(model)),
            graph, banks)
        loss, grads = trainer.gradients(*trainer.batch(
            torch.tensor(IDX), torch.tensor(MASK)))
        out[remat] = (trainer.model.encodes, loss, grads)
    assert out[False][0] == out[True][0] == 1
    assert_bit_equal(out[True][1], out[False][1], "loss")
    for g, w in zip(out[True][2], out[False][2]):
        assert_bit_equal(g, w, "grad")


@pytest.mark.parametrize("argv,want", [([], False), (["--remat"], True)])
def test_remat_flag_reaches_the_config(argv, want):
    args = cli.build_parser().parse_args(["--dataset", "Toy", *argv])
    assert cli.config_from_args(args).remat is want
