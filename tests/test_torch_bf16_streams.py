"""The opt-in bf16 cotangent streams against the JAX package's: each knob is
set on both sides (the JAX package's ``spmm_pallas`` module constants and
the port's of the same name, read from the same environment variables).

  * ``MGCN_CONTRIB`` (kgc_gcn_torch/ops/scatter.py, models/mgcn.py;
    ``spmm_pallas.py:664-668``): one half on the ``use_pallas`` path and the
    stacked_xla view; ``sub``/``corr``, runs without ``use_pallas``, K4b,
    the bf16 message mode and the ``operands``/``fwdw`` schedules stay
    uncast.
  * ``EDGE_CONTRIB`` (ops/sorted_ops.py, models/rgat.py;
    ``spmm_pallas.py:1588-1596``): ``edge_compose`` and the RGAT encoder on
    the ``use_pallas`` path.
  * ``BASIS_READBACK`` (ops/basis.py, models/rgcn.py;
    ``spmm_pallas.py:1515-1525``): the basis aggregate and the R-GCN
    encoder on the band backward's path; ``narrow`` is ``wide``.

The order of rounding is pinned where it happens: each op test feeds both
packages the same inputs, records the stream that reaches the src-order
segment-sum (the port's ``seg_sum``, the JAX package's
``segment_sum_pallas``, its Pallas kernel in interpret mode) and holds the
two bf16 streams equal to the bit.  Where the float32 values that are
rounded come out of a sum (the basis backward's d_msg), the inputs are
small integers, so that both packages compute them exactly.  The summed
d_x is then held at ``SUM_TOL``, far below the cast's own effect (one bf16
step, 2**-8 relative), and the float32 stream is shown to miss it.

The encoder tests check the wiring end to end: float32 values that differ
by float32 noise may round one bf16 step apart, so each gradient is held
within rtol 1e-2 and an absolute 1e-2 of its largest element, and the cast
is shown to have taken place.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kgc_gcn_tpu.ops.spmm_pallas as jsp

from kgc_gcn_torch.convert import jax_leaf_names
from kgc_gcn_torch.models import build_model
from kgc_gcn_torch.ops import basis, scatter, sorted_ops
from kgc_gcn_torch.ops.basis import basis_aggregate
from kgc_gcn_torch.ops.kernels import KERNELS
from kgc_gcn_torch.ops.scatter import aggregate_half, aggregate_stacked_xla
from kgc_gcn_torch.ops.segment_sum import segment_sum
from kgc_gcn_torch.ops.sorted_ops import edge_compose
from test_torch_common import (
    jax_and_port_models, jax_leaves, port_cfg, port_toy, rgat_cfg, rgcn_cfg)

BF16_RTOL = 1e-2
# the float32 sum of the same bf16 stream in another order of addition
SUM_TOL = dict(rtol=1e-6, atol=0.0)
# the JAX package's one-hot products (hi/lo bf16 halves) against the
# port's sums, for the gradients that no stream touches
F32_TOL = dict(rtol=1e-4, atol=1e-5)


def close_bf16(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=BF16_RTOL,
                               atol=BF16_RTOL * np.abs(want).max(),
                               err_msg=what)


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


class _Streams:
    """Records the bf16 value streams that reach the src-order sum: the
    port's through a ``seg_sum`` wrapper, the JAX package's through
    ``spmm_pallas.segment_sum_pallas`` (which its backwards look up at call
    time)."""

    def __init__(self, monkeypatch):
        self.port, self.jax = [], []
        orig = jsp.segment_sum_pallas

        def jax_rec(vals, *a, **k):
            if vals.dtype == jnp.bfloat16:
                self.jax.append(np.asarray(vals.astype(jnp.float32)))
            return orig(vals, *a, **k)
        monkeypatch.setattr(jsp, "segment_sum_pallas", jax_rec)

    def seg_sum(self, vals, *a, **k):
        if vals.dtype == torch.bfloat16:
            self.port.append(vals.float().numpy())
        return segment_sum(vals, *a, **k)

    def assert_bit_equal(self, rows: int, cols: int):
        """One stream on each side, equal to the bit (a bf16 value is exact
        in float32) over the real rows and columns."""
        assert len(self.port) == len(self.jax) == 1, (len(self.port),
                                                      len(self.jax))
        np.testing.assert_array_equal(self.port[0][:rows, :cols],
                                      self.jax[0][:rows, :cols])


def _dx_pinned(got, want, f32):
    """d_x of the bf16 stream at SUM_TOL, which the float32 stream's d_x
    misses: the tolerance sees the cast."""
    np.testing.assert_allclose(got, want, err_msg="d_x", **SUM_TOL)
    assert not np.allclose(f32, want, **SUM_TOL)


@pytest.mark.parametrize("view", ["half", "stacked_xla"])
def test_mgcn_contrib_matches_jax(toy, monkeypatch, view):
    ds, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    n, d = ds.num_entity, 8
    stacked = view == "stacked_xla"
    etab_shape = (2, pgraph.e_pad, d) if stacked else (pgraph.e_pad, d)
    arrays = _draw(5, (n, d), (2 * ds.num_relation + 1, d), etab_shape,
                   (2 * n if stacked else n, d))
    x, rel_all, etab, cot = arrays
    streams = _Streams(monkeypatch)

    def port(contrib_dtype):
        args = [torch.from_numpy(a).requires_grad_()
                for a in (x, rel_all, etab)]
        kw = dict(seg_sum=streams.seg_sum, contrib_dtype=contrib_dtype)
        if stacked:
            out = torch.cat(aggregate_stacked_xla(
                args[0], args[1], args[2].reshape(2 * pgraph.e_pad, -1),
                pgraph.stacked, n, **kw))
        else:
            out = aggregate_half(*args, pgraph.outb, n, **kw)
        return [g.numpy() for g in torch.autograd.grad(
            (out * torch.from_numpy(cot)).sum(), args)]

    def jax_grads():
        def f(x_, r_, e_):
            if stacked:
                out = jnp.concatenate(jsp.aggregate_stacked_xla(
                    x_, r_, e_.reshape(2 * pgraph.e_pad, d), jgraph.stacked,
                    n, interpret=True))
            else:
                out = jsp.aggregate_half_pallas(x_, r_, e_, jgraph.outb, n,
                                                interpret=True)
            return jnp.sum(out * cot)
        return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
            *map(jnp.asarray, arrays[:3]))]

    f32 = port(None)
    monkeypatch.setattr(jsp, "MGCN_CONTRIB", "bf16")
    got, want = port("bfloat16"), jax_grads()
    streams.assert_bit_equal(2 * pgraph.e_pad if stacked else pgraph.e_pad, d)
    _dx_pinned(got[0], want[0], f32[0])
    for g, w, g32, name in zip(got[1:], want[1:], f32[1:],
                               ("d_rel", "d_etab")):
        np.testing.assert_array_equal(g, g32, err_msg=name)   # float32
        np.testing.assert_allclose(g, w, err_msg=name, **F32_TOL)


def _port_encoder_grads(cfg, seed: int = 2) -> dict:
    """The port's gradients of a sum over its encoder's outputs, on the toy
    graph, from weights made from ``seed``."""
    ds, pgraph, _ = port_toy()
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=pgraph.e_pad,
                        generator=torch.Generator().manual_seed(seed))
    ent, rel = model.encode(pgraph)
    (ent.square().sum() + rel.sum()).backward()
    return {k: p.grad.numpy() for k, p in model.named_parameters()
            if p.grad is not None}


_MGCN_UNCAST = [
    ("mult", dict(use_pallas=False)),
    ("corr", dict(use_pallas=False, composition="corr")),
    ("sub", dict(use_pallas=False, composition="sub")),
    ("ew_pallas", dict(use_pallas=True, ew_impl="pallas")),
    ("bf16_messages", dict(use_pallas=True, compute_dtype="bfloat16")),
    ("operands", dict(use_pallas=True, bwd_perm="operands")),
    ("fwdw", dict(use_pallas=True, bwd_perm="fwdw"))]


@pytest.mark.parametrize("kw", [kw for _, kw in _MGCN_UNCAST],
                         ids=[name for name, _ in _MGCN_UNCAST])
def test_mgcn_contrib_stays_off_the_paths_jax_leaves_uncast(toy_cfg,
                                                            monkeypatch, kw):
    """Where the JAX package has no cast (its ``scatter.py`` path, K4b, the
    bf16 message mode's own cast, the schedules that compose in src order)
    the knob changes no bit of the MGCN encoder's gradients."""
    cfg = port_cfg(toy_cfg).replace(gcn_drop=0.0, conv_drop=0.0, **kw)
    off = _port_encoder_grads(cfg)
    monkeypatch.setattr(scatter, "MGCN_CONTRIB", "bf16")
    on = _port_encoder_grads(cfg)
    for name, g in off.items():
        np.testing.assert_array_equal(on[name], g, err_msg=name)


def test_mgcn_contrib_reaches_the_encoder(toy_cfg, monkeypatch):
    """On the ``use_pallas`` path the knob moves the entity gradient and
    leaves the relation and edge tables' gradients on their float32
    values, at any depth."""
    cfg = port_cfg(toy_cfg).replace(use_pallas=True, gcn_drop=0.0,
                                    conv_drop=0.0, num_layers=2)
    off = _port_encoder_grads(cfg)
    monkeypatch.setattr(scatter, "MGCN_CONTRIB", "bf16")
    on = _port_encoder_grads(cfg)
    assert not np.array_equal(on["entity_embedding"],
                              off["entity_embedding"])
    np.testing.assert_allclose(on["entity_embedding"],
                               off["entity_embedding"], rtol=BF16_RTOL,
                               atol=BF16_RTOL * np.abs(
                                   off["entity_embedding"]).max())


@pytest.mark.parametrize("use_pallas", [True, False])
def test_edge_contrib_matches_jax(toy, toy_cfg, monkeypatch, use_pallas):
    """``edge_compose``'s d_h stream and gradients against the JAX
    package's ``edge_compose`` under ``EDGE_CONTRIB=bf16``; off the
    ``use_pallas`` path (where the JAX package runs no ``edge_compose``)
    the port's RGAT keeps every float32 bit."""
    if not use_pallas:
        cfg = port_cfg(rgat_cfg(toy_cfg, use_pallas=False))
        off = _port_encoder_grads(cfg)
        monkeypatch.setattr(sorted_ops, "EDGE_CONTRIB", "bf16")
        on = _port_encoder_grads(cfg)
        for name, g in off.items():
            np.testing.assert_array_equal(on[name], g, err_msg=name)
        return
    _, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    jh, ph = jgraph.outb, pgraph.outb
    n, e = jgraph.n_ent, int(jh.src.shape[0])
    h, r, cot = _draw(7, (n, 16), (2 * jgraph.n_rel, 16), (e, 16))
    streams = _Streams(monkeypatch)

    def port(contrib_dtype):
        args = [torch.from_numpy(a).requires_grad_() for a in (h, r)]
        z = edge_compose(*args, ph, streams.seg_sum, contrib_dtype)
        return [g.numpy() for g in torch.autograd.grad(
            (z * torch.from_numpy(cot)).sum(), args)]

    f32 = port(torch.float32)
    monkeypatch.setattr(jsp, "EDGE_CONTRIB", "bf16")
    got = port(torch.bfloat16)
    rdata = (jh.rperm, jh.r_indptr, jh.r_rel)
    want = [np.asarray(g) for g in jax.grad(lambda h_, r_: jnp.sum(
        jsp.edge_compose(h_, r_, jh.src, jh.rel, jh.sperm, jh.s_indptr,
                         jh.s_src, rdata, n, True) * cot),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(r))]
    streams.assert_bit_equal(e, 16)
    _dx_pinned(got[0], want[0], f32[0])
    np.testing.assert_array_equal(got[1], f32[1])
    np.testing.assert_allclose(got[1], want[1], err_msg="d_rel_mult",
                               **F32_TOL)


@pytest.mark.parametrize("which", ["inb", "outb"])
def test_basis_readback_stream_matches_jax(toy, monkeypatch, which):
    """The basis aggregate's readback under ``BASIS_READBACK=bf16``
    against ``basis_aggregate_fused`` with the band backward's plan: d_msg
    and ``s_norm`` cast to bf16 before the permutation and multiplied in
    bf16.  The cotangent and coefficients are small integers, so that each
    package's d_msg (a sum over the bases) is exact and the two round the
    same float32 values."""
    ds, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    jhalf, phalf = getattr(jgraph, which), getattr(pgraph, which)
    n, nb, d = ds.num_entity, 3, 8
    rng = np.random.default_rng(9)
    x = rng.normal(size=(n, d)).astype(np.float32)
    coeff = rng.integers(-16, 17, size=(2 * ds.num_relation, nb)
                         ).astype(np.float32)
    cot = rng.integers(-64, 65, size=(n, nb, d)).astype(np.float32)
    streams = _Streams(monkeypatch)
    kernels = dataclasses.replace(KERNELS, seg_sum=streams.seg_sum)

    def port(readback_dtype):
        xt = torch.from_numpy(x).requires_grad_()
        ct = torch.from_numpy(coeff).requires_grad_()
        agg = basis_aggregate(xt, ct, phalf, n, kernels, readback_dtype)
        (agg.view(n, nb, d) * torch.from_numpy(cot)).sum().backward()
        return xt.grad.numpy(), ct.grad.numpy()

    f32 = port(torch.float32)
    monkeypatch.setattr(jsp, "BASIS_READBACK", "bf16")
    got = port(torch.bfloat16)
    plan, plan_meta = jsp.build_basis_bwd_plan(jhalf, n)
    want = [np.asarray(g) for g in jax.grad(lambda xv, cv: jnp.sum(
        jsp.basis_aggregate_fused(
            xv, cv, jhalf.src, jhalf.dst, jhalf.rel, jhalf.norm,
            jhalf.indptr, jhalf.sperm, jhalf.s_indptr, jhalf.s_src,
            (jhalf.rperm, jhalf.r_indptr, jhalf.r_rel), plan, n, nb, True,
            plan_meta)[:, :, :d] * cot), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(coeff))]
    streams.assert_bit_equal(int(phalf.src.shape[0]), d)
    _dx_pinned(got[0], want[0], f32[0])
    np.testing.assert_array_equal(got[1], f32[1])             # d_coeff
    # the integer cotangent makes d_coeff large: F32_TOL's atol relative
    # to its largest element
    np.testing.assert_allclose(got[1], want[1], err_msg="d_coeff",
                               rtol=F32_TOL["rtol"], atol=F32_TOL["atol"]
                               * np.abs(want[1]).max())


def _encoder_grads_vs_jax(toy, cfg, seed, prepare=False):
    """(port grads, JAX grads) of a weighted sum of the encoder's outputs,
    keyed by the encoder parameters' names."""
    model, params, state, port = jax_and_port_models(toy, cfg, seed=seed)
    _, jgraph, _ = toy
    _, pgraph, _ = port_toy()
    if prepare:
        model.prepare_kernels(jgraph)
    rng = np.random.default_rng(seed)
    w_ent = rng.normal(size=(jgraph.n_ent, 16)).astype(np.float32)
    w_rel = rng.normal(size=(2 * jgraph.n_rel, 16)).astype(np.float32)

    def f(p):
        ent, rel, _ = model.encode(p, state, jgraph)
        return jnp.sum(ent * w_ent) + jnp.sum(rel * w_rel)
    want = jax_leaves(jax.grad(f)(params))
    ent, rel = port.encode(pgraph)
    ((ent * torch.from_numpy(w_ent)).sum()
     + (rel * torch.from_numpy(w_rel)).sum()).backward()
    names = [k for k in jax_leaf_names(port.cfg)[0]
             if not k.startswith("decoder.")]
    return ({k: port.get_parameter(k).grad.numpy() for k in names},
            {k: want[k] for k in names})


def test_edge_contrib_rgat_encoder_matches_jax(toy, toy_cfg, monkeypatch):
    cfg = rgat_cfg(toy_cfg, use_pallas=True)
    f32, _ = _encoder_grads_vs_jax(toy, cfg, seed=3)
    monkeypatch.setattr(jsp, "EDGE_CONTRIB", "bf16")
    monkeypatch.setattr(sorted_ops, "EDGE_CONTRIB", "bf16")
    got, want = _encoder_grads_vs_jax(toy, cfg, seed=3)
    for name, w in want.items():
        close_bf16(got[name], w, name)
    assert not np.array_equal(got["entity_embedding"],
                              f32["entity_embedding"])


@pytest.mark.parametrize("layers", [1, 2])
def test_basis_readback_rgcn_encoder_matches_jax(toy, toy_cfg, monkeypatch,
                                                 layers):
    """R-GCN's encoder gradients on the band backward's path (the JAX model
    prepared with its plan), ``BASIS_READBACK=bf16`` on both sides."""
    cfg = rgcn_cfg(toy_cfg, use_pallas=True, num_layers=layers)
    f32, _ = _encoder_grads_vs_jax(toy, cfg, seed=4, prepare=True)
    monkeypatch.setattr(jsp, "BASIS_READBACK", "bf16")
    monkeypatch.setattr(basis, "BASIS_READBACK", "bf16")
    got, want = _encoder_grads_vs_jax(toy, cfg, seed=4, prepare=True)
    for name, w in want.items():
        close_bf16(got[name], w, name)
    assert not np.array_equal(got["entity_embedding"],
                              f32["entity_embedding"])
    # the last layer's coefficients take no cotangent through a readback
    last = f"layers.{layers - 1}.coeff"
    np.testing.assert_array_equal(got[last], f32[last])


@pytest.mark.parametrize("value,use_pallas", [("narrow", True),
                                              ("bf16", False)])
def test_basis_readback_leaves_the_float32_numbers(toy, toy_cfg, monkeypatch,
                                                   value, use_pallas):
    """``narrow`` is a TPU layout of ``wide``'s numbers, and without
    ``use_pallas`` (the JAX package's XLA backward) ``bf16`` is not read:
    the port's gradients keep every bit."""
    cfg = port_cfg(rgcn_cfg(toy_cfg, use_pallas=use_pallas))
    port_a = _port_encoder_grads(cfg)
    monkeypatch.setattr(basis, "BASIS_READBACK", value)
    port_b = _port_encoder_grads(cfg)
    for name, g in port_a.items():
        np.testing.assert_array_equal(port_b[name], g, err_msg=name)
