"""The optimizer layer's kernel wrapper on the CPU: ``ops/fused_adam.py``
runs ``optim.step`` on CPU tensors, to the bit and without counting a
launch; it refuses what its kernel does not take; ``Trainer`` steps through
it unless ``plain=True``, which keeps ``optim.step``.  The kernel itself
runs on the card (``tests/test_torch_cuda.py``)."""

import dataclasses

import pytest
import torch

from kgc_gcn_torch.config import Config
from kgc_gcn_torch.ops.fused_adam import fused_adam
from kgc_gcn_torch.ops.kernels import KERNELS, PLAIN
from kgc_gcn_torch.train import optim

SHAPES = [(7, 3), (5,), (2, 2, 2), (1,)]


def leaves(moment_dtype: str, seed: int = 0):
    """(params, state, the gradients of 3 steps)."""
    gen = torch.Generator().manual_seed(seed)
    params = [torch.randn(s, generator=gen) for s in SHAPES]
    state = optim.init_state(params, Config(moment_dtype=moment_dtype))
    steps = [[torch.randn(s, generator=gen) * (k + 1) for s in SHAPES]
             for k in range(3)]
    return params, state, steps


@pytest.mark.parametrize("moment_dtype,clip,wd", [
    ("float32", 0.5, 0.0), ("float32", 100.0, 0.01), ("float32", 0.0, 0.0),
    ("bfloat16", 0.5, 0.01), ("bfloat16", 100.0, 0.0)])
def test_fused_adam_on_cpu_is_the_plain_step(moment_dtype, clip, wd):
    """Three steps through the wrapper and three through ``optim.step`` from
    the same leaves: the same bits, and no launch counted."""
    cfg = Config(clip_grad=clip, weight_decay=wd, moment_dtype=moment_dtype)
    params, state, steps = leaves(moment_dtype)
    pp = [p.clone() for p in params]
    ps = optim.init_state(pp, cfg)
    start = fused_adam.launches
    for grads, lr in zip(steps, (1e-2, 3e-3, 1e-3)):
        fused_adam(params, grads, state, cfg, lr)
        optim.step(pp, grads, ps, cfg, lr)
    assert fused_adam.launches == start
    assert state.count == ps.count == 3
    for got, want in zip(params + state.mu + state.nu, pp + ps.mu + ps.nu):
        assert got.dtype == want.dtype
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def _bad(case: str):
    params, state, steps = leaves("float32")
    grads = steps[0]
    if case == "float64_grad":
        grads[1] = grads[1].double()
    elif case == "float64_param":
        params[0] = params[0].double()
    elif case == "mixed_moments":
        state.nu[2] = state.nu[2].bfloat16()
    elif case == "float16_moments":
        state.mu = [m.half() for m in state.mu]
        state.nu = [v.half() for v in state.nu]
    elif case == "shape":
        grads[0] = grads[0].reshape(3, 7)
    elif case == "non_contiguous":
        grads[0] = torch.randn(3, 7).T
    elif case == "count":
        grads = grads[:-1]
    elif case == "sharded_flags":
        return params, grads, state, [False]
    return params, grads, state, ()


@pytest.mark.parametrize("case", [
    "float64_grad", "float64_param", "mixed_moments", "float16_moments",
    "shape", "non_contiguous", "count", "sharded_flags"])
def test_fused_adam_refuses_what_its_kernel_does_not_take(case):
    """The wrapper checks its leaves on every device, so that a CPU run
    refuses what the card would: float32 parameters and gradients, one
    moment dtype of float32 or bf16, equal shapes, contiguous tensors, one
    gradient, two moments and no or one sharded flag a leaf."""
    params, grads, state, sharded = _bad(case)
    before = [p.clone() for p in params]
    with pytest.raises(ValueError):
        fused_adam(params, grads, state, Config(), 1e-3, sharded)
    assert state.count == 0
    assert all(torch.equal(a, b) for a, b in zip(params, before))


def test_every_kernel_field_counts_its_launches():
    """``benchmark/lib/port.py:counters`` reads ``.launches`` on every field
    of ``Kernels`` in ``KERNELS``; the optimizer's is the fused step."""
    for f in dataclasses.fields(KERNELS):
        assert type(getattr(KERNELS, f.name).launches) is int, f.name
    assert KERNELS.adam is fused_adam
    assert PLAIN.adam is optim.step


def _toy_trainer(plain: bool):
    from kgc_gcn_torch.config import dataset_preset
    from kgc_gcn_torch.data.batching import make_banks
    from kgc_gcn_torch.data.dataset import build_dataset
    from kgc_gcn_torch.data.graph import build_graph
    from kgc_gcn_torch.data.toy import toy_triples
    from kgc_gcn_torch.models import build_model
    from kgc_gcn_torch.train.loop import Trainer
    ds = build_dataset("toy", *toy_triples(n_ent=30, n_rel=4, n_train=120))
    graph = build_graph(ds.train_triples, ds.num_entity, ds.num_relation)
    cfg = dataset_preset("Toy", gcn_in_dim=8, gcn_out_dim=16, k_w=4, k_h=4,
                         num_filter=2, kernel_size=3, batch_size=8, seed=3)
    torch.manual_seed(0)
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=graph.e_pad)
    return Trainer(cfg, model, graph, make_banks(ds, "cpu"), plain=plain)


def test_train_step_routes_the_optimizer_through_the_bundle():
    """``Trainer.train_step`` calls the bundle's optimizer with the
    trainer's leaves, state, lr and sharded flags: the fused step's wrapper
    through ``KERNELS``, ``optim.step`` with ``plain=True``; on the CPU the
    two steps give the same bits."""
    out = {}
    for plain in (False, True):
        t = _toy_trainer(plain)
        assert t.kernels.adam is (optim.step if plain else fused_adam)
        calls = []

        def spy(params, grads, state, cfg, lr, sharded, group,
                inner=t.kernels.adam):
            calls.append((params, state, lr, sharded, group))
            inner(params, grads, state, cfg, lr, sharded, group)

        t.kernels = dataclasses.replace(t.kernels, adam=spy)
        idx = torch.arange(8)
        t.generator.manual_seed(1)
        t.train_step(2e-3, *t.batch(idx, torch.ones(8)))
        [(params, state, lr, sharded, group)] = calls
        assert params is t.params and state is t.opt_state
        assert (lr, sharded, group) == (2e-3, t.sharded, None)
        out[plain] = [p.detach().clone() for p in t.params] + t.opt_state.mu
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)
