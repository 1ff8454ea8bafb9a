"""Edge sampling (BASELINE config 4) and the reference aggregation schedule
in the port against the JAX package (kgc_gcn_torch/ops/sampler.py,
ops/scatter.py:aggregate_half_reference_schedule, models/mgcn.py): the
sampled aggregate and its gradients on positions handed to both packages,
the draw itself, one sampled training step, the full-graph evaluation
encode, and the reference schedule alone and inside the encoder.

The two packages draw from different generators (jax.random against
torch.Generator), so the tests hand both the same numpy-drawn positions:
JAX's ``jax.random.randint`` is replaced by them, and the port's
``sample_half`` by ``take_half`` on them.  Dropout is off.  Tolerances:
aggregates and encodes 1e-5 (float32 sums in another order), gradients
``GRAD_RTOL`` with the absolute part relative to each tensor's largest and
its floor, loss rtol 1e-5 (tests/test_torch_train.py); the sampled step's
ConvE directions that BatchNorm cancels relative to the step's largest
gradient (tests/test_torch_decoders.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kgc_gcn_torch.models.mgcn as pmgcn
from kgc_gcn_tpu.ops import sampler as jsampler
from kgc_gcn_tpu.ops.scatter import (
    aggregate_half_reference_schedule as jax_reference_schedule)
from kgc_gcn_tpu.train import loop as jloop

from kgc_gcn_torch.convert import jax_leaf_names
from kgc_gcn_torch.ops.sampler import (
    aggregate_sampled_half, sample_half, take_half)
from kgc_gcn_torch.ops.scatter import aggregate_half_reference_schedule
from kgc_gcn_torch.train import loop as ploop
from test_torch_common import jax_and_port_models, jax_leaves, port_cfg, port_toy

TOL = 1e-5
GRAD_RTOL, GRAD_ATOL, GRAD_FLOOR = 2e-4, 2e-5, 1e-7
LOSS_RTOL = 1e-5
DEGENERATE = ("decoder.bn0.bias", "decoder.bn0.scale", "decoder.fc_b")
K = 24


def close(got, want, rtol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def close_grad(got, want, what, scale=None):
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(
        got, want, rtol=GRAD_RTOL,
        atol=max(GRAD_FLOOR, GRAD_ATOL * scale), err_msg=what)


def operands(graph, d: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in (
        (graph.n_ent, d), (2 * graph.n_rel + 1, d), (graph.e_pad, d),
        (graph.n_ent, d))]


@pytest.mark.parametrize("half_name", ["inb", "outb"])
def test_sampled_aggregate_and_grads_match_jax(toy, monkeypatch, half_name):
    """The same positions (duplicates included) through JAX ``sample_half``
    and ``aggregate_sampled_half`` and through the port's: the rescaled
    norms, the (N, d) unsorted sum and its gradients with respect to x,
    rel_all and the edge table."""
    _, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    x, rel, etab, g = operands(jgraph, 12, seed=1)
    idx = np.random.default_rng(2).integers(0, jgraph.n_edge, size=K)
    idx[:3] = idx[3]                                   # a duplicate
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(idx, jnp.int32))
    jhalf = jsampler.sample_half(jax.random.PRNGKey(0),
                                 getattr(jgraph, half_name), K, jgraph.n_edge)
    want, vjp = jax.vjp(
        lambda a, b, c: jsampler.aggregate_sampled_half(a, b, c, jhalf,
                                                        jgraph.n_ent),
        x, rel, etab)
    want_grads = vjp(jnp.asarray(g))
    sample = take_half(getattr(pgraph, half_name), torch.from_numpy(idx),
                       pgraph.n_edge)
    np.testing.assert_array_equal(sample.norm.numpy(), np.asarray(jhalf.norm))
    np.testing.assert_array_equal(sample.dst.numpy(), np.asarray(jhalf.dst))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, rel, etab)]
    out = aggregate_sampled_half(*ts, sample, pgraph.n_ent)
    out.backward(torch.from_numpy(g))
    close(out.detach(), want, TOL, "sampled aggregate")
    for t, w, what in zip(ts, want_grads, ("d_x", "d_rel", "d_etab")):
        close_grad(t.grad.numpy(), np.asarray(w), what)


def test_sample_half_draws_real_positions_from_the_generator():
    """K uniform draws with replacement among the real edges, on the
    half's device, from the generator: one seed, one sample."""
    _, pgraph, _ = port_toy()
    half = pgraph.inb
    draw = lambda seed: sample_half(torch.Generator().manual_seed(seed), half,
                                    500, pgraph.n_edge)
    a, b, c = draw(3), draw(3), draw(4)
    assert torch.equal(a.eid, b.eid) and not torch.equal(a.eid, c.eid)
    assert a.eid.shape == (500,) and a.eid.device == half.src.device
    assert int(a.eid.min()) == 0 and int(a.eid.max()) == pgraph.n_edge - 1
    assert torch.equal(a.src, half.src[a.eid]) and torch.equal(
        a.rel, half.rel[a.eid])
    scale = np.float32(pgraph.n_edge) / np.float32(500)
    np.testing.assert_array_equal(a.norm.numpy(),
                                  half.norm[a.eid].numpy() * scale)


def test_sampled_training_step_matches_jax(toy, toy_cfg, monkeypatch):
    """One MGCN 1-vs-all step with ``edge_sample_size`` K on the same
    positions in both packages (in-half, then out-half): loss and every
    gradient against JAX ``Trainer._train_step`` with an identity
    optimizer (grad = (p - new) / lr)."""
    lr = 1e4
    cfg = toy_cfg.replace(edge_sample_size=K, gcn_drop=0.0, conv_drop=0.0,
                          feat_drop=0.0, hidden_drop=0.0)
    model, params, state, port = jax_and_port_models(toy, cfg, seed=3)
    _, jgraph, jbanks = toy
    _, pgraph, pbanks = port_toy()
    rng = np.random.default_rng(4)
    draws = [rng.integers(0, jgraph.n_edge, size=K) for _ in range(2)]
    jit = iter(draws)
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi:
                        jnp.asarray(next(jit), jnp.int32))
    pit = iter(draws)
    monkeypatch.setattr(pmgcn, "sample_half", lambda gen, half, k, n:
                        take_half(half, torch.from_numpy(next(pit)), n))
    bank = jbanks["train"]
    idx = np.array([5, 2, 7, 0])
    mask = np.array([1, 1, 1, 0], np.float32)
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
    ptr = ploop.Trainer(port_cfg(cfg), port, pgraph, pbanks)
    loss = ptr.loss(*(torch.from_numpy(a) for a in (q, li, mask)))
    grads = torch.autograd.grad(loss, ptr.params)
    assert next(pit, None) is None                  # both halves sampled
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=LOSS_RTOL)
    g_max = max(np.abs(v).max() for v in want.values())
    for name, g in zip(jax_leaf_names(port.cfg)[0], grads):
        close_grad(g.numpy(), want[name], name,
                   g_max if name in DEGENERATE else None)
    # only sampled edges receive a gradient in their embedding rows
    touched = np.zeros(pgraph.e_pad, bool)
    touched[draws[0]] = True
    assert not np.abs(want["edge_embeddings"][0][~touched]).any()


def test_evaluation_encodes_the_full_graph(toy_cfg):
    """train=False ignores edge_sample_size: the same encode as without
    sampling."""
    ds, pgraph, _ = port_toy()
    cfg = port_cfg(toy_cfg)
    a = pmgcn.MGCN(cfg.replace(edge_sample_size=K), ds.num_entity,
                   ds.num_relation, ds.num_edge, pgraph.e_pad).eval()
    b = pmgcn.MGCN(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                   pgraph.e_pad).eval()
    with torch.no_grad():
        for got, want in zip(a.encode(pgraph), b.encode(pgraph)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("half_name", ["inb", "outb"])
def test_reference_schedule_matches_jax(toy, half_name):
    """The bench-only schedule (project every edge, then an unsorted sum)
    and its gradients against JAX's."""
    _, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    x, rel, etab, _ = operands(jgraph, 8, seed=5)
    rng = np.random.default_rng(6)
    w = rng.normal(size=(8, 10)).astype(np.float32)
    g = rng.normal(size=(jgraph.n_ent, 10)).astype(np.float32)
    jhalf = getattr(jgraph, half_name)
    want, vjp = jax.vjp(lambda a, b, c, d: jax_reference_schedule(
        a, b, c, jhalf, d, jgraph.n_ent), x, rel, etab, w)
    want_grads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, rel, etab, w)]
    out = aggregate_half_reference_schedule(
        *ts[:3], getattr(pgraph, half_name), ts[3], pgraph.n_ent)
    out.backward(torch.from_numpy(g))
    close(out.detach(), want, TOL, "reference schedule")
    for t, wg, what in zip(ts, want_grads, ("d_x", "d_rel", "d_etab", "d_w")):
        close_grad(t.grad.numpy(), np.asarray(wg), what)


def test_reference_schedule_encode_matches_jax(toy, toy_cfg):
    cfg = toy_cfg.replace(agg_schedule="reference")
    model, params, state, port = jax_and_port_models(toy, cfg, seed=7)
    _, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    want_ent, want_rel, _ = model.encode(params, state, jgraph, train=False)
    with torch.no_grad():
        ent, rel = port.encode(pgraph)
    close(ent, want_ent, TOL, "all_ent")
    close(rel, want_rel, TOL, "all_rel")
