"""``--ckpt_every``: the background periodic checkpoint
(kgc_gcn_torch/train/checkpoint.py:AsyncCheckpointer, train/loop.py)
against the JAX package's semantics (``checkpoint.py:138-206``,
``loop.py:384-390,418-419``).

The port writes ``periodic.ckpt`` in ``last.ckpt``'s npz layout: the JAX
package's ``load_checkpoint`` reads it with a JAX template and the port's
reads it by path.  The save is a snapshot: a parameter changed in place
right after it returns does not reach the file.  At most one write is in
flight, and the promotion leaves a loadable file at every instant; the loop
joins the last write at its end, also when it leaves on an exception.
"""

import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from kgc_gcn_tpu.models import build_model as jax_build_model
from kgc_gcn_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from kgc_gcn_tpu.train.optim import make_optimizer

from kgc_gcn_torch import cli
from kgc_gcn_torch.config import Config
from kgc_gcn_torch.convert import jax_leaf_names, params_to_numpy
from kgc_gcn_torch.data.toy import write_toy
from kgc_gcn_torch.models import build_model
from kgc_gcn_torch.train import checkpoint as pckpt
from kgc_gcn_torch.train import loop as ploop
from kgc_gcn_torch.train.checkpoint import (
    PERIODIC_NAME, AsyncCheckpointer, load_checkpoint)
from test_torch_common import jax_leaves, port_cfg, port_toy

FLAGS = ["--gcn_in_dim", "8", "--gcn_out_dim", "16", "--k_w", "4", "--k_h",
         "4", "--num_filter", "4", "--kernel_size", "3", "--device", "cpu"]


def _trained(toy_cfg, steps=2):
    """A port MGCN + ConvE and its trainer after ``steps`` steps."""
    cfg = port_cfg(toy_cfg)
    ds, graph, banks = port_toy()
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=graph.e_pad)
    trainer = ploop.Trainer(cfg, model, graph, banks)
    for s in range(steps):
        trainer.train_step(1e-2, *trainer.batch(torch.arange(4 * s, 4 * s + 4),
                                                torch.ones(4)))
    return cfg, model, trainer


def test_jax_reads_the_periodic_checkpoint(toy, toy_cfg, tmp_path):
    cfg, model, trainer = _trained(toy_cfg)
    writer = AsyncCheckpointer()
    path = writer.save_checkpoint_async(str(tmp_path), model,
                                        trainer.opt_state, cfg, 0.125)
    writer.wait_for_async_checkpoints()
    assert path == str(tmp_path / PERIODIC_NAME)
    assert sorted(os.listdir(tmp_path)) == [PERIODIC_NAME]
    ds, graph, _ = toy
    jmodel = jax_build_model(toy_cfg, ds.num_entity, ds.num_relation,
                             ds.num_edge, e_pad=graph.e_pad)
    params, state = jmodel.init(jax.random.PRNGKey(0))
    tree, measure = jax_load_checkpoint(path, {
        "params": params, "state": state,
        "opt_state": make_optimizer(toy_cfg).init(params)})
    assert measure == 0.125
    ours, our_state = params_to_numpy(model, cfg)
    for name, v in jax_leaves(tree["params"]).items():
        np.testing.assert_array_equal(v, ours[name], err_msg=name)
    for name, v in jax_leaves(tree["state"]).items():
        np.testing.assert_array_equal(v, our_state[name], err_msg=name)
    adam = tree["opt_state"][-1]
    assert int(adam.count) == trainer.opt_state.count == 2
    for name, t in zip(jax_leaf_names(cfg)[0], trainer.opt_state.mu):
        np.testing.assert_array_equal(np.asarray(jax_leaves(adam.mu)[name]),
                                      t.numpy(), err_msg=name)


def test_an_update_in_place_after_the_save_does_not_reach_the_file(
        toy_cfg, tmp_path, monkeypatch):
    """The writer thread is held until the parameters, BN statistics and
    moments have all been changed in place; the file holds the values of
    the moment of the save."""
    cfg, model, trainer = _trained(toy_cfg)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    want_mu = [m.clone() for m in trainer.opt_state.mu]
    gate = threading.Event()
    write = pckpt._write_npz
    monkeypatch.setattr(pckpt, "_write_npz",
                        lambda *a: (gate.wait(10), write(*a)))
    writer = AsyncCheckpointer()
    path = writer.save_checkpoint_async(str(tmp_path), model,
                                        trainer.opt_state, cfg, 0.5)
    with torch.no_grad():
        for t in list(model.state_dict().values()) + trainer.opt_state.mu:
            t.add_(1.0)
    gate.set()
    writer.wait_for_async_checkpoints()
    sd, measure, opt = load_checkpoint(path, cfg, with_opt_state=True)
    assert measure == 0.5
    for k, v in want.items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0, msg=k)
    for got, m in zip(opt.mu, want_mu):
        torch.testing.assert_close(got, m, rtol=0, atol=0)


def test_promotion_leaves_a_loadable_file_at_every_instant(
        toy_cfg, tmp_path, monkeypatch):
    """While a second write is in flight, and when the process dies between
    the promotion's two renames, the first save stays loadable; a failed
    write raises at the next join and leaves the previous file."""
    cfg, model, trainer = _trained(toy_cfg)
    writer = AsyncCheckpointer()
    path = writer.save_checkpoint_async(str(tmp_path), model,
                                        trainer.opt_state, cfg, 0.25)
    writer.wait_for_async_checkpoints()
    first = load_checkpoint(path, cfg)[0]

    gate = threading.Event()
    write = pckpt._write_npz
    monkeypatch.setattr(pckpt, "_write_npz",
                        lambda *a: (gate.wait(10), write(*a)))
    with torch.no_grad():
        model.entity_embedding.add_(1.0)
    writer.save_checkpoint_async(str(tmp_path), model, trainer.opt_state,
                                 cfg, 0.5)
    sd, measure = load_checkpoint(path, cfg)       # mid-write
    assert measure == 0.25
    torch.testing.assert_close(sd["entity_embedding"],
                               first["entity_embedding"], rtol=0, atol=0)
    gate.set()

    # a crash after the first rename: the old file waits at .old
    replace, calls = os.replace, []

    def crash_on_second(src, dst):
        calls.append(dst)
        if len(calls) == 2:
            raise OSError("killed between the renames")
        replace(src, dst)

    monkeypatch.setattr(pckpt.os, "replace", crash_on_second)
    with pytest.raises(OSError, match="between the renames"):
        writer.wait_for_async_checkpoints()
    assert load_checkpoint(path + ".old", cfg)[1] == 0.25
    assert load_checkpoint(path + ".tmp", cfg)[1] == 0.5
    monkeypatch.setattr(pckpt.os, "replace", replace)

    # a write that fails raises at the join; the last good file stays
    def fail(*a):
        raise OSError("disk full")

    monkeypatch.setattr(pckpt, "_write_npz", fail)
    os.replace(path + ".old", path)
    writer.save_checkpoint_async(str(tmp_path), model, trainer.opt_state,
                                 cfg, 0.75)
    with pytest.raises(OSError, match="disk full"):
        writer.wait_for_async_checkpoints()
    assert load_checkpoint(path, cfg)[1] == 0.25
    writer.wait_for_async_checkpoints()             # nothing left in flight


@pytest.mark.parametrize("ckpt_every", [1, 2])
def test_cli_writes_periodic_checkpoints_as_jax_does(tmp_path, ckpt_every):
    """``--ckpt_every``: the file holds the last multiple's epoch, saved
    before its validation with the best measure so far; here it is the
    run's final parameters (3 epochs, the last a multiple of 1; with 2, the
    file is epoch 2's and epoch 3 moved on)."""
    write_toy(str(tmp_path / "data"))
    exp = tmp_path / "exp"
    assert cli.main(["--dataset", "Toy", "--data_dir", str(tmp_path / "data"),
                     "--experiments_dir", str(exp), "--do_train",
                     "--max_epoch", "3", "--batch_size", "64",
                     "--ckpt_every", str(ckpt_every)] + FLAGS) == 0
    run = exp / "Toy"
    assert sorted(p for p in os.listdir(run) if "ckpt" in p) == [
        "last.ckpt", PERIODIC_NAME]
    with open(run / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f][1:]
    saved_epoch = 3 - 3 % ckpt_every
    best_before = max([0.0] + [r["val"]["mrr"] for r in recs[:saved_epoch - 1]])
    cfg = Config.from_json(str(run / "params.json"))
    sd, measure = load_checkpoint(str(run / PERIODIC_NAME), cfg)
    assert measure == pytest.approx(best_before, abs=1e-6)
    if ckpt_every == 1:
        final = _final_params(tmp_path, cfg)
        for k, v in final.items():
            torch.testing.assert_close(sd[k], v, rtol=0, atol=0, msg=k)


def _final_params(tmp_path, cfg):
    """The run's final parameters: replay its 3 epochs in process with the
    CLI's seed (the CLI does the same steps on the same device)."""
    from kgc_gcn_torch.data.batching import make_banks
    from kgc_gcn_torch.data.dataset import load_dataset
    from kgc_gcn_torch.data.graph import build_graph
    ds = load_dataset("Toy", str(tmp_path / "data"))
    graph = build_graph(ds.train_triples, ds.num_entity, ds.num_relation)
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=graph.e_pad)
    trainer = ploop.Trainer(cfg, model, graph, make_banks(ds))
    ploop.train_and_evaluate(trainer, None, seed=cfg.seed % 2**32)
    return model.state_dict()


def test_the_loop_joins_its_write_when_it_leaves_on_an_exception(
        toy_cfg, tmp_path, monkeypatch):
    """Epoch 1 saves; epoch 2's training raises: the write in flight is
    joined and promoted before the exception leaves ``train_and_evaluate``."""
    cfg, model, trainer = _trained(toy_cfg, steps=0)
    trainer.cfg = cfg = cfg.replace(ckpt_every=1, max_epoch=3, eval_every=5)
    gate = threading.Event()
    write = pckpt._write_npz
    monkeypatch.setattr(pckpt, "_write_npz",
                        lambda *a: (gate.wait(0.5), write(*a)))
    epoch_of = trainer.train_epoch

    def train_epoch(epoch, host_rng, max_steps=None):
        if epoch == 2:
            raise RuntimeError("epoch 2 failed")
        return epoch_of(epoch, host_rng, max_steps)

    trainer.train_epoch = train_epoch
    with pytest.raises(RuntimeError, match="epoch 2 failed"):
        ploop.train_and_evaluate(trainer, str(tmp_path), seed=3)
    assert sorted(p for p in os.listdir(tmp_path) if "ckpt" in p) == [
        PERIODIC_NAME]
    sd, measure = load_checkpoint(str(tmp_path / PERIODIC_NAME), cfg)
    assert measure == 0.0
    for k, v in model.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0, msg=k)
