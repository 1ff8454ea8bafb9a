"""The port's training path against the JAX package's
(kgc_gcn_torch/train/{loop,optim}.py, models/{common,decoders,mgcn}.py in
train mode, data/batching.py): one step's gradients and BN statistics, a
4-epoch trajectory, the optimizer, the learning-rate schedules, dropout and
the early-stopping rule.

Dropout rates are 0 wherever the two packages are compared: their random
streams differ (jax.random keys against one torch.Generator).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kgc_gcn_tpu.config import Config as JaxConfig
from kgc_gcn_tpu.data.batching import epoch_batches as jax_epoch_batches
from kgc_gcn_tpu.train import loop as jloop
from kgc_gcn_tpu.train.optim import apply_updates_with_lr, make_optimizer
from kgc_gcn_tpu.train.optim import epoch_lr as jax_epoch_lr

from kgc_gcn_torch.config import Config
from kgc_gcn_torch.convert import jax_leaf_names, params_to_numpy
from kgc_gcn_torch.data.batching import epoch_batches
from kgc_gcn_torch.models.common import dropout
from kgc_gcn_torch.train import loop as ploop
from kgc_gcn_torch.train import optim
from test_torch_common import jax_and_port_models, jax_leaves, port_cfg, port_toy

# one step's gradients: float32 sums in another order through the encoder,
# the decoder and the loss; their error scales with the summands, so the
# absolute part is relative to each tensor's largest gradient, with a floor
# for one-element sums that cancel (bn0's scale: ~5e-6 from summands ~1e-3)
GRAD_RTOL, GRAD_ATOL, GRAD_FLOOR = 2e-4, 2e-5, 1e-7
# BN running statistics: one momentum step on batch statistics
BN_TOL = dict(rtol=1e-5, atol=1e-6)
# Degenerate directions: ConvE's fc bias feeds BN2, and bn0's bias becomes a
# per-filter constant after the conv, which BN1 removes.  Their true gradient
# is 0 and both packages leave float noise there (which Adam scales to steps
# of size lr): their gradients are held to ~0, their deltas left out.
DEGENERATE = ("decoder.bn0.bias", "decoder.fc_b")
NOISE = 1e-5
# Over several steps, also bn0's scale (degenerate up to BN1's eps) and the
# running statistics those directions feed (BN1's mean and variance, BN2's
# mean) carry that noise.  Eval BN uses running statistics, so the noise
# reaches eval scores and may flip near-tied ranks: the JAX package's own
# sparse and fused runs differ by that much.
TRAJ_DEGENERATE = DEGENERATE + ("decoder.bn0.scale",)
TRAJ_NOISY_STATE = ("decoder.bn1.mean", "decoder.bn1.var", "decoder.bn2.mean")
# Val metrics over the 16 toy queries: a few rank steps
VAL_TOL = {"mr": 0.25, "mrr": 0.01, "hits@1": 0.13, "hits@3": 0.13,
           "hits@10": 0.13}


def no_dropout(cfg, **kw):
    return cfg.replace(gcn_drop=0.0, conv_drop=0.0, hidden_drop=0.0,
                       feat_drop=0.0, **kw)


def copy_leaves(tree):
    return {k: np.array(v, copy=True) for k, v in jax_leaves(tree).items()}


def port_state(port):
    """{JAX state path: array} of the port's BN running statistics."""
    return params_to_numpy(port, port.cfg)[1]


@pytest.mark.parametrize("impl", ["sparse", "fused", "dense"])
def test_train_step_gradients_and_bn_stats_match_jax(toy, toy_cfg, impl):
    """Gradients of every parameter and the new BN statistics of one step
    against JAX ``Trainer._train_step``, which runs here with an identity
    optimizer: new = p - lr * grad, so grad = (p - new) / lr (a large lr
    keeps p's rounding out of the difference)."""
    lr = 1e4
    cfg = no_dropout(toy_cfg, loss_impl=impl, lbl_smooth=0.1)
    model, params, state, port = jax_and_port_models(toy, cfg, seed=3)
    _, jgraph, jbanks = toy
    _, pgraph, pbanks = port_toy()
    bank = jbanks["train"]
    idx = np.array([5, 2, 7, 0])                 # the last row is padding
    mask = np.array([1, 1, 1, 0], np.float32)
    q = np.asarray(bank.queries)[idx]
    li = np.asarray(bank.label_idx)[idx]

    p0, s0 = copy_leaves(params), copy_leaves(state)   # donated below
    trainer = jloop.Trainer(cfg, model, jgraph, jbanks)
    trainer.tx = optax.identity()
    new_p, new_s, _, j_loss = trainer._train_step_jit(
        params, state, trainer.tx.init(params), jgraph, jnp.float32(lr),
        jnp.asarray(q), jnp.asarray(li), jnp.asarray(mask),
        jax.random.PRNGKey(0))
    want = {k: (p0[k].astype(np.float64) - v.astype(np.float64)) / lr
            for k, v in jax_leaves(new_p).items()}

    ptrainer = ploop.Trainer(port_cfg(cfg), port, pgraph, pbanks)
    assert ptrainer.loss_impl == impl
    loss = ptrainer.loss(*(torch.from_numpy(a) for a in (q, li, mask)))
    grads = torch.autograd.grad(loss, ptrainer.params)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    names = jax_leaf_names(port.cfg)[0]
    assert len(names) == len(grads)
    for name, g in zip(names, grads):
        if name in DEGENERATE:
            assert max(np.abs(g.numpy()).max(), np.abs(want[name]).max()) < NOISE
            continue
        np.testing.assert_allclose(
            g.numpy(), want[name], rtol=GRAD_RTOL,
            atol=max(GRAD_FLOOR, GRAD_ATOL * np.abs(want[name]).max()),
            err_msg=name)
    got_state, want_state = port_state(port), jax_leaves(new_s)
    for name, v in want_state.items():
        np.testing.assert_allclose(got_state[name], v, err_msg=name, **BN_TOL)
    # the randomized statistics moved
    assert not np.allclose(got_state["conv_bn.var"], s0["conv_bn.var"])


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("impl", ["sparse", "fused"])
def test_four_epoch_trajectory_matches_jax(toy, toy_cfg, impl, tmp_path):
    """4 dropout-free epochs through both packages' ``train_and_evaluate``
    with one seed (so one batch plan): per-epoch losses and Val metrics,
    the best measure, final parameter deltas and BN running statistics.
    StepLR fires after epoch 2."""
    cfg = no_dropout(toy_cfg, loss_impl=impl, batch_size=8, lr_step_size=2,
                     lr_gamma=0.9, learning_rate=5e-3, num_filter=2,
                     max_epoch=4, eval_every=1)
    model, params, state, port = jax_and_port_models(toy, cfg, seed=4)
    _, jgraph, jbanks = toy
    _, pgraph, pbanks = port_toy()
    p0 = copy_leaves(params)

    jtr = jloop.Trainer(cfg, model, jgraph, jbanks)
    jp, js, _, jbest = jloop.train_and_evaluate(
        jtr, params, state, make_optimizer(cfg).init(params),
        model_dir=str(tmp_path), seed=11)
    (tmp_path / "port").mkdir()
    ptr = ploop.Trainer(port_cfg(cfg), port, pgraph, pbanks)
    pbest = ploop.train_and_evaluate(ptr, model_dir=str(tmp_path / "port"),
                                     seed=11)

    got = _records(tmp_path / "port" / "metrics.jsonl")
    want = _records(tmp_path / "metrics.jsonl")
    assert [r.get("epoch") for r in got] == [None, 1, 2, 3, 4]
    assert [r.get("epoch") for r in want] == [None, 1, 2, 3, 4]
    for g, w in zip(got[1:], want[1:]):
        # metrics.jsonl rounds losses to 6 digits and metrics to 5
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-4, abs=2e-6)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-12)
        for k, v in w["val"].items():
            assert g["val"][k] == pytest.approx(v, abs=VAL_TOL[k]), (g["epoch"], k)
    assert pbest == pytest.approx(jbest, abs=VAL_TOL["mrr"])

    # parameter movement from init (measured: within 2e-6 of movements
    # ~0.1), relative to each tensor's largest movement
    sd = port.state_dict()
    for name, want_final in jax_leaves(jp).items():
        if name in TRAJ_DEGENERATE:
            continue
        w_delta = want_final.astype(np.float64) - p0[name]
        g_delta = sd[name].numpy().astype(np.float64) - p0[name]
        np.testing.assert_allclose(g_delta, w_delta, rtol=1e-4,
                                   atol=1e-4 * np.abs(w_delta).max(),
                                   err_msg=name)
    for name, v in jax_leaves(js).items():
        if name not in TRAJ_NOISY_STATE:
            np.testing.assert_allclose(port_state(port)[name], v, rtol=1e-5,
                                       atol=1e-6, err_msg=name)


@pytest.mark.parametrize("moment_dtype,clip,wd", [
    ("float32", 0.5, 0.0), ("float32", 100.0, 0.01), ("float32", 0.0, 0.0),
    ("bfloat16", 0.5, 0.01), ("bfloat16", 100.0, 0.0)])
def test_optimizer_matches_optax(moment_dtype, clip, wd):
    """Three steps of the port's optimizer against the JAX package's optax
    chain: clipping above (0.5) and below (100) the global norm, off (0),
    weight decay, float32 and bf16 moments."""
    cfg = Config(clip_grad=clip, weight_decay=wd, moment_dtype=moment_dtype)
    jcfg = JaxConfig(clip_grad=clip, weight_decay=wd, moment_dtype=moment_dtype)
    rng = np.random.default_rng(0)
    shapes = [(7, 3), (5,), (2, 2, 2)]
    p_np = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = make_optimizer(jcfg)
    jp = [jnp.asarray(a) for a in p_np]
    jstate = tx.init(jp)
    pp = [torch.from_numpy(a.copy()) for a in p_np]
    pstate = optim.init_state(pp, cfg)
    for step, lr in enumerate((1e-2, 3e-3, 1e-3)):
        g_np = [rng.normal(size=s).astype(np.float32) * (step + 1)
                for s in shapes]
        upd, jstate = tx.update([jnp.asarray(g) for g in g_np], jstate, jp)
        jp = apply_updates_with_lr(jp, upd, jnp.float32(lr))
        optim.step(pp, [torch.from_numpy(g) for g in g_np], pstate, cfg, lr)
        for got, want in zip(pp, jp):
            # float32 update arithmetic in another operation order
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
    adam = jstate[-1]
    assert pstate.count == int(adam.count) == 3
    lowp = moment_dtype == "bfloat16"
    for got, want in zip(pstate.mu + pstate.nu, list(adam.mu) + list(adam.nu)):
        assert got.dtype == (torch.bfloat16 if lowp else torch.float32)
        # bf16 moments: one float32 ulp can flip a bf16 rounding
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=8e-3 if lowp else 1e-6, atol=1e-7)


@pytest.mark.parametrize("schedule", ["step", "cosine", "constant"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_epoch_lr_matches_jax(schedule, warmup):
    kw = dict(lr_schedule=schedule, warmup_epochs=warmup, max_epoch=25,
              lr_step_size=4, lr_gamma=0.5, learning_rate=0.01)
    for epoch in range(1, 31):
        assert optim.epoch_lr(Config(**kw), epoch) == pytest.approx(
            jax_epoch_lr(JaxConfig(**kw), epoch), rel=1e-12), epoch


def test_epoch_batches_match_jax():
    for n, b in ((10, 4), (12, 4), (1, 3)):
        got = epoch_batches(n, b, np.random.default_rng(5))
        want = jax_epoch_batches(n, b, np.random.default_rng(5))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_dropout_keep_fraction_scaling_and_seed():
    x = torch.ones(400, 500)
    gen = lambda s: torch.Generator().manual_seed(s)
    y = dropout(x, 0.3, gen(1), train=True)
    kept = y != 0
    # 200,000 draws: the keep fraction is within 0.005 of 0.7 (>10 sigma)
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    assert torch.all(y[kept] == 1 / 0.7)
    assert torch.equal(dropout(x, 0.3, gen(1), train=True), y)
    assert not torch.equal(dropout(x, 0.3, gen(2), train=True), y)
    for rate, g, train in ((0.3, gen(1), False), (0.0, gen(1), True),
                           (0.3, None, True)):
        assert dropout(x, rate, g, train) is x


class _Scripted:
    """A trainer whose validation MRR follows a script (both packages'
    ``train_and_evaluate`` read only these members)."""

    def __init__(self, cfg, mrrs):
        self.cfg, self.mrrs, self.epoch = cfg, list(mrrs), 0
        self.graph = type("G", (), {"num_messages": 10})()
        self.steps_per_epoch, self.mesh = 1, None
        self.generator = torch.Generator()
        self.model = self.opt_state = None

    def train_epoch(self, *args, **kwargs):
        self.epoch += 1
        return (*args[:3], 1.0) if len(args) > 3 else 1.0

    def evaluate(self, *args, **kwargs):
        m = self.mrrs[self.epoch - 1]
        return {"mr": 1.0, "mrr": m, "hits@1": m, "hits@3": m, "hits@10": m}


def test_patience_and_early_stop_match_jax(tmp_path, monkeypatch):
    """The patience quirk (an improvement below ``patience`` counts as
    stale), saves on every improvement and the early stop after
    ``min_epoch``, against the JAX package's ``train_and_evaluate`` on one
    scripted MRR sequence."""
    mrrs = [0.1, 0.105, 0.3, 0.301, 0.2, 0.302, 0.1, 0.1, 0.5, 0.6]
    kw = dict(max_epoch=10, min_epoch=4, eval_every=1, patience=0.01,
              patience_num=3)
    saves = {"jax": [], "port": []}
    monkeypatch.setattr(jloop, "save_checkpoint",
                        lambda d, tree, m: saves["jax"].append(m))
    monkeypatch.setattr(ploop, "save_checkpoint",
                        lambda d, model, opt, cfg, m: saves["port"].append(m))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jbest = jloop.train_and_evaluate(_Scripted(JaxConfig(**kw), mrrs), None,
                                     None, None, str(tmp_path / "jax"))[3]
    pbest = ploop.train_and_evaluate(_Scripted(Config(**kw), mrrs),
                                     str(tmp_path / "port"))
    assert pbest == jbest == 0.302
    assert saves["port"] == saves["jax"] == [0.1, 0.105, 0.3, 0.301, 0.302]
    strip = lambda rs: [{k: v for k, v in r.items()
                         if k not in ("sec", "steps_per_s")} for r in rs]
    got = strip(_records(tmp_path / "port" / "metrics.jsonl"))
    want = strip(_records(tmp_path / "jax" / "metrics.jsonl"))
    assert got == want
    # epoch 6 improves by less than patience: best moves, and it is the
    # third stale evaluation after epoch min_epoch, so training stops there
    assert got[-1]["epoch"] == 6
