"""Checkpoints the port writes (kgc_gcn_torch/train/checkpoint.py,
convert.py): the JAX package reads them leaf for leaf, the port resumes
from them, and the CLI trains, saves and then serves from its own run.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgc_gcn_tpu.config import Config as JaxConfig
from kgc_gcn_tpu.data.batching import make_banks as jax_make_banks
from kgc_gcn_tpu.data.dataset import load_dataset as jax_load_dataset
from kgc_gcn_tpu.data.graph import build_graph as jax_build_graph
from kgc_gcn_tpu.data.toy import write_toy
from kgc_gcn_tpu.models import build_model as jax_build_model
from kgc_gcn_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from kgc_gcn_tpu.train.loop import Trainer as JaxTrainer
from kgc_gcn_tpu.train.optim import make_optimizer

from kgc_gcn_torch import cli
from kgc_gcn_torch.config import Config
from kgc_gcn_torch.convert import jax_leaf_names, params_to_numpy
from kgc_gcn_torch.models import build_model
from kgc_gcn_torch.train.checkpoint import load_checkpoint, save_checkpoint
from kgc_gcn_torch.train.loop import Trainer
from test_torch_common import jax_leaves, port_cfg, port_toy


def _trained(toy_cfg, moment_dtype, steps=2):
    """A port model and Trainer after ``steps`` steps (non-zero moments,
    moved BN statistics)."""
    cfg = port_cfg(toy_cfg).replace(moment_dtype=moment_dtype, seed=3)
    ds, graph, banks = port_toy()
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=graph.e_pad,
                        generator=torch.Generator().manual_seed(1))
    trainer = Trainer(cfg, model, graph, banks)
    bank = banks["train"]
    for s in range(steps):
        idx = torch.arange(4 * s, 4 * s + 4)
        trainer.train_step(1e-2, bank.queries[idx], bank.label_idx[idx],
                           torch.ones(4))
    return cfg, model, trainer


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_jax_reads_the_port_checkpoint(toy, toy_cfg, tmp_path, moment_dtype):
    cfg, model, trainer = _trained(toy_cfg, moment_dtype)
    save_checkpoint(str(tmp_path), model, trainer.opt_state, cfg, 0.375)

    ds, jgraph, _ = toy
    jcfg = toy_cfg.replace(moment_dtype=moment_dtype)
    jmodel = jax_build_model(jcfg, ds.num_entity, ds.num_relation, ds.num_edge,
                             e_pad=jgraph.e_pad)
    params, state = jmodel.init(jax.random.PRNGKey(0))
    template = {"params": params, "state": state,
                "opt_state": make_optimizer(jcfg).init(params)}
    tree, measure = jax_load_checkpoint(str(tmp_path), template)
    assert measure == 0.375

    p_names = jax_leaf_names(cfg)[0]
    for tree_key, ours in zip(("params", "state"), params_to_numpy(model, cfg)):
        want = jax_leaves(tree[tree_key])
        assert list(want) == list(ours)
        for name, v in want.items():
            np.testing.assert_array_equal(v, ours[name], err_msg=name)
    adam = tree["opt_state"][-1]
    assert int(adam.count) == trainer.opt_state.count == 2
    want_dtype = jnp.bfloat16 if moment_dtype == "bfloat16" else jnp.float32
    for moments, ours in ((adam.mu, trainer.opt_state.mu),
                          (adam.nu, trainer.opt_state.nu)):
        leaves = jax.tree.leaves(moments)
        assert len(leaves) == len(ours) == len(p_names)
        for name, v, t in zip(p_names, leaves, ours):
            assert v.dtype == want_dtype, name
            np.testing.assert_array_equal(np.asarray(v, np.float32),
                                          t.float().numpy(), err_msg=name)
    assert float(jnp.abs(jax.tree.leaves(adam.nu)[0]).max()) > 0


def test_port_resumes_from_its_checkpoint(toy_cfg, tmp_path):
    """Read back params, BN statistics and Adam state: one more step from
    the restored copy equals one more step of the original."""
    cfg, model, trainer = _trained(toy_cfg, "float32")
    save_checkpoint(str(tmp_path), model, trainer.opt_state, cfg, 0.5)
    sd, measure, opt = load_checkpoint(str(tmp_path), cfg, with_opt_state=True)
    assert measure == 0.5 and opt.count == 2

    ds, graph, banks = port_toy()
    twin = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                       e_pad=graph.e_pad)
    twin.load_state_dict(sd)
    resumed = Trainer(cfg, twin, graph, banks)
    resumed.opt_state = opt
    trainer.generator.manual_seed(3)           # same dropout masks
    bank = banks["train"]
    idx = torch.arange(8, 12)
    for t in (trainer, resumed):
        t.train_step(1e-2, bank.queries[idx], bank.label_idx[idx], torch.ones(4))
    for (name, a), b in zip(model.state_dict().items(),
                            twin.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_cli_trains_then_serves_its_checkpoint(tmp_path, caplog, capsys):
    """``--do_train --max_epoch 2 --device cpu`` writes params.json,
    last.ckpt and metrics.jsonl; ``--do_test --restore_dir`` serves the
    checkpoint with the metrics the JAX package computes from it, and
    ``--do_predict`` answers from it."""
    data_dir, exp = str(tmp_path / "data"), str(tmp_path / "exp")
    write_toy(data_dir, "Toy")
    small = ["--gcn_in_dim", "16", "--num_filter", "8"]
    base = ["--dataset", "Toy", "--data_dir", data_dir, "--device", "cpu"]
    assert cli.main(base + small + ["--do_train", "--max_epoch", "2",
                                    "--experiments_dir", exp]) == 0
    run = tmp_path / "exp" / "Toy"
    assert {"params.json", "last.ckpt", "metrics.jsonl"} <= {
        p.name for p in run.iterdir()}
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 3 and '"run_start": true' in lines[0]

    with caplog.at_level(logging.INFO):
        assert cli.main(base + ["--do_test", "--restore_dir", str(run),
                                "--experiments_dir",
                                str(tmp_path / "test")]) == 0
    line = next(r.getMessage() for r in caplog.records
                if "Test metrics" in r.getMessage())
    got = dict(kv.split(": ") for kv in line.split("metrics: ")[1].strip()
               .split("; "))

    cfg = Config.from_json(str(run / "params.json"))
    jcfg = JaxConfig.from_json(str(run / "params.json"))
    ds = jax_load_dataset("Toy", data_dir)
    graph = jax_build_graph(ds.train_triples, ds.num_entity, ds.num_relation)
    jmodel = jax_build_model(jcfg, ds.num_entity, ds.num_relation, ds.num_edge,
                             e_pad=graph.e_pad)
    params, state = jmodel.init(jax.random.PRNGKey(0))
    tree, _ = jax_load_checkpoint(str(run), {
        "params": params, "state": state,
        "opt_state": make_optimizer(jcfg).init(params)})
    want = JaxTrainer(jcfg, jmodel, graph, jax_make_banks(ds)).evaluate(
        tree["params"], tree["state"], "test", mark="Test")
    assert cfg.gcn_in_dim == 16
    for k, v in want.items():
        assert float(got[k]) == pytest.approx(v, abs=1e-3), k   # log: 3 digits

    qf = tmp_path / "q.txt"
    qf.write_text("e0\tr1\ne3\tr0\n")
    capsys.readouterr()
    assert cli.main(base + ["--do_predict", "--predict_file", str(qf),
                            "--top_k", "3", "--restore_dir", str(run),
                            "--experiments_dir", str(tmp_path / "pred")]) == 0
    answers = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(a["subject"], len(a["topk"])) for a in answers] == [("e0", 3),
                                                                ("e3", 3)]
