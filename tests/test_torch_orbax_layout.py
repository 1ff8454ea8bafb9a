"""The port's writer and reader of orbax's plain directory layout
(kgc_gcn_torch/train/orbax_layout.py, train/checkpoint.py) against orbax
itself, through the JAX package's ``save_checkpoint(..., backend="orbax")``
and ``load_checkpoint``.

The key table is pinned against the ``_METADATA`` that the JAX package
writes for the same config, node for node; the JAX package reads what the
port writes bit for bit; the port reads its own directories on one device
and, chunk by chunk, on the slices of a 2-rank mesh; orbax's OCDBT and
compressed layouts are refused; a crash between the write and the rename
leaves the previous checkpoint loadable.
"""

import copy
import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

ocp = pytest.importorskip("orbax.checkpoint")

from kgc_gcn_tpu.models import build_model as jax_build_model  # noqa: E402
from kgc_gcn_tpu.train.checkpoint import (  # noqa: E402
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint)
from kgc_gcn_tpu.train.optim import make_optimizer  # noqa: E402

from kgc_gcn_torch.convert import (  # noqa: E402
    jax_leaf_names, params_to_numpy)
from kgc_gcn_torch.models import build_model  # noqa: E402
from kgc_gcn_torch.parallel.mesh import Mesh, edge_slice  # noqa: E402
from kgc_gcn_torch.train import checkpoint as pckpt  # noqa: E402
from kgc_gcn_torch.train import orbax_layout  # noqa: E402
from kgc_gcn_torch.train.checkpoint import (  # noqa: E402
    AsyncCheckpointer, load_checkpoint)
from kgc_gcn_torch.train.loop import Trainer  # noqa: E402
from test_torch_common import (  # noqa: E402
    jax_leaves, port_cfg, port_toy, rgat_cfg, rgcn_cfg)

CONFIGS = {
    "mgcn": {},
    "mgcn_2_layers": dict(num_layers=2, bias=True, weight_decay=0.01),
    "mgcn_bf16": dict(moment_dtype="bfloat16", clip_grad=0.0),
    "rgcn": "rgcn",
    "rgat": "rgat",
}


def _cfg(toy_cfg, name):
    kw = CONFIGS[name]
    if kw == "rgcn":
        return rgcn_cfg(toy_cfg)
    if kw == "rgat":
        return rgat_cfg(toy_cfg, num_layers=2)
    return toy_cfg.replace(**kw)


def _trained(cfg, steps=2):
    """A port model and trainer after ``steps`` steps (non-zero moments)."""
    ds, graph, banks = port_toy()
    model = build_model(port_cfg(cfg), ds.num_entity, ds.num_relation,
                        ds.num_edge, e_pad=graph.e_pad,
                        generator=torch.Generator().manual_seed(1))
    trainer = Trainer(port_cfg(cfg), model, graph, banks)
    for s in range(steps):
        trainer.train_step(1e-2, *trainer.batch(
            torch.arange(4 * s, 4 * s + 4), torch.ones(4)))
    return model, trainer


def _jax_template(toy, cfg):
    ds, graph, _ = toy
    model = jax_build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                            e_pad=graph.e_pad)
    params, state = model.init(jax.random.PRNGKey(0))
    return {"params": params, "state": state,
            "opt_state": make_optimizer(cfg).init(params)}


def _write_periodic(path, model, trainer, measure):
    writer = AsyncCheckpointer()
    out = writer.save_checkpoint_async(str(path), model, trainer.opt_state,
                                       model.cfg, measure)
    writer.wait_for_async_checkpoints()
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_key_table_equals_the_jax_writers_metadata(toy, toy_cfg, tmp_path,
                                                   name):
    """(a) Every node orbax records for the JAX CLI's tree (``None`` leaves
    and empty tuples included), with its key types, value type and write
    shape, is the port's ``_METADATA`` entry for the same config; the
    array leaves of params and state are ``convert.jax_leaf_names``."""
    cfg = _cfg(toy_cfg, name)
    jax_save_checkpoint(str(tmp_path), _jax_template(toy, cfg), 0.5,
                        backend="orbax")
    with open(tmp_path / "last.orbax" / "_METADATA") as f:
        want = json.load(f)["tree_metadata"]
    model, trainer = _trained(cfg, steps=0)
    plan = pckpt._Plan(model, trainer.opt_state, model.cfg, 0.5, None)
    assert plan.meta["tree_metadata"] == want
    entries = orbax_layout.tree_entries(model.cfg)
    assert [str(e.keys) for e in entries] == list(plan.meta["tree_metadata"])
    arrays = lambda part: [".".join(e.keys[2:]) for e in entries
                           if e.keys[:2] == ("tree", part)
                           and e.kind == orbax_layout.ARRAY]
    assert (arrays("params"), arrays("state")) == jax_leaf_names(model.cfg)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_jax_reads_the_port_directory_bit_for_bit(toy, toy_cfg, tmp_path,
                                                  moment_dtype):
    """(b) The JAX package's ``load_checkpoint`` of a directory the port
    wrote: the measure, every parameter and BN statistic, Adam's count and
    both moments (float32 or bf16) equal the port's, to the bit."""
    cfg = toy_cfg.replace(moment_dtype=moment_dtype)
    model, trainer = _trained(cfg)
    path = _write_periodic(tmp_path, model, trainer, 0.375)
    tree, measure = jax_load_checkpoint(path, _jax_template(toy, cfg))
    assert measure == 0.375
    for part, ours in zip(("params", "state"),
                          params_to_numpy(model, model.cfg)):
        want = jax_leaves(tree[part])
        assert list(want) == list(ours)
        for k, v in want.items():
            np.testing.assert_array_equal(v, ours[k], err_msg=k)
    adam = tree["opt_state"][-1]
    assert int(adam.count) == trainer.opt_state.count == 2
    for moments, ours in ((adam.mu, trainer.opt_state.mu),
                          (adam.nu, trainer.opt_state.nu)):
        for v, t in zip(jax.tree.leaves(moments), ours):
            assert str(v.dtype) == moment_dtype
            bits = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
            np.testing.assert_array_equal(
                np.asarray(v).view(np.dtype(str(bits).split(".")[1])),
                t.view(bits).numpy())


def _same_state(got, want):
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_port_round_trips_on_one_device_and_by_slice(toy_cfg, tmp_path):
    """(c) The port reads its own directory on one device (every leaf and
    moment to the bit), and the directory two graph ranks write (their
    chunks ``0.g.0``, written here in turn) on each rank's slice of a
    2-rank mesh from that rank's chunks alone; one device then misses the
    chunks taken away."""
    model, trainer = _trained(toy_cfg.replace(moment_dtype="bfloat16"))
    cfg = model.cfg
    path = _write_periodic(tmp_path / "one", model, trainer, 0.25)
    sd, measure, opt = load_checkpoint(path, cfg, with_opt_state=True)
    assert measure == 0.25 and opt.count == 2
    _same_state(sd, model.state_dict())
    for a, b in zip(opt.mu + opt.nu, trainer.opt_state.mu
                    + trainer.opt_state.nu):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    root = str(tmp_path / "two")
    e_pad = model.edge_embeddings.shape[1]
    i = jax_leaf_names(cfg)[0].index("edge_embeddings")
    for g in (0, 1):   # each rank's part, as the ranks write it
        mesh = Mesh(1, 2, g, torch.device("cpu"))
        part = copy.deepcopy(model)
        cut = edge_slice(e_pad, mesh)
        part.edge_embeddings = torch.nn.Parameter(
            part.edge_embeddings.detach()[:, cut].clone())
        sliced = lambda ms: [m[:, cut] if j == i else m
                             for j, m in enumerate(ms)]
        slices = dataclasses.replace(trainer.opt_state,
                                     mu=sliced(trainer.opt_state.mu),
                                     nu=sliced(trainer.opt_state.nu))
        written = pckpt._write_files(root, pckpt._Plan(part, slices, cfg,
                                                       0.25, mesh), root)
        assert (f"tree.params.edge_embeddings/0.{g}.0" in written
                and ("_METADATA" in written) == (g == 0))
    sd, _, opt = load_checkpoint(root, cfg, with_opt_state=True)
    _same_state(sd, model.state_dict())
    for g in (0, 1):
        mesh = Mesh(1, 2, g, torch.device("cpu"))
        mine = str(tmp_path / f"rank{g}")
        shutil.copytree(root, mine)
        for leaf in os.listdir(mine):   # the other rank's chunks go
            other = os.path.join(mine, leaf, f"0.{1 - g}.0")
            if os.path.exists(other):
                os.remove(other)
        sd_g, _, opt_g = load_checkpoint(mine, cfg, with_opt_state=True,
                                         mesh=mesh)
        cut = edge_slice(e_pad, mesh)
        want = dict(model.state_dict())
        want["edge_embeddings"] = want["edge_embeddings"][:, cut]
        _same_state(sd_g, want)
        for got, full in ((opt_g.mu[i], trainer.opt_state.mu[i]),
                          (opt_g.nu[i], trainer.opt_state.nu[i])):
            torch.testing.assert_close(got, full[:, cut], rtol=0, atol=0)
        with pytest.raises(FileNotFoundError, match="chunk is missing"):
            load_checkpoint(mine, cfg)


@pytest.mark.parametrize("kind", ["ocdbt", "compressed"])
def test_orbax_defaults_are_refused(toy, toy_cfg, tmp_path, kind):
    """(d) A directory of the JAX package's orbax writer (OCDBT, its
    default) and a non-OCDBT one with zstd chunks: refused, naming the npz
    backend as the way across."""
    tree = _jax_template(toy, toy_cfg)
    if kind == "ocdbt":
        jax_save_checkpoint(str(tmp_path), tree, 0.5, backend="orbax")
    else:
        ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False)).save(
            str(tmp_path / "last.orbax"),
            {"tree": tree, "__measure__": np.asarray(0.5, np.float32)})
    what = "an OCDBT" if kind == "ocdbt" else "a compressed zarr leaf"
    with pytest.raises(ValueError, match=f"{what}.*no reader for") as e:
        load_checkpoint(str(tmp_path), port_cfg(toy_cfg))
    assert "backend='npz'" in str(e.value)


def test_a_crash_between_write_and_rename_keeps_the_last_checkpoint(
        toy_cfg, tmp_path, monkeypatch):
    """(e) A second checkpoint written to ``.tmp``: before its commit, and
    when the process dies between the commit's two renames, the first
    stays loadable (at its name, then at ``.old``); a rank's failed write
    raises at the commit and promotes nothing."""
    model, trainer = _trained(toy_cfg)
    cfg = model.cfg
    final = _write_periodic(tmp_path, model, trainer, 0.25)
    tmp = final + ".tmp"
    with torch.no_grad():
        model.entity_embedding.add_(1.0)
    pckpt._write_files(tmp, pckpt._Plan(model, trainer.opt_state, cfg, 0.5,
                                        None), final)
    assert load_checkpoint(final, cfg)[1] == 0.25   # written, not renamed
    replace, calls = os.replace, []

    def crash_on_second(src, dst):
        calls.append(dst)
        if len(calls) == 2:
            raise OSError("killed between the renames")
        replace(src, dst)

    monkeypatch.setattr(pckpt.os, "replace", crash_on_second)
    with pytest.raises(OSError, match="between the renames"):
        pckpt._commit(tmp, final, None, None)
    monkeypatch.setattr(pckpt.os, "replace", replace)
    assert not os.path.exists(final)
    assert load_checkpoint(final + ".old", cfg)[1] == 0.25
    sd, measure = load_checkpoint(tmp, cfg)
    assert measure == 0.5
    _same_state(sd, model.state_dict())

    os.replace(final + ".old", final)
    with pytest.raises(OSError, match="disk full"):
        pckpt._commit(tmp, final, None, OSError("disk full"))
    assert load_checkpoint(final, cfg)[1] == 0.25
