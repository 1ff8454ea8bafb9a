"""``--restore_torch``: the reference implementation's PyTorch checkpoint
(kgc_gcn_torch/utils/torch_import.py, cli.py, the optional MGCN conv bias of
models/mgcn.py and convert.py) against the JAX package's
(``kgc_gcn_tpu/utils/torch_import.py``, ``cli.py:381-392``).

The JAX package's ``save_reference_checkpoint`` writes the file, with and
without the conv bias ``conv1.bias`` and ConvE's ``conv2.conv_e.bias``; the
port's CLI reads it (``--do_test``) and gives the JAX package's encode and
test metrics; the port's own ``save_reference_checkpoint`` is read back by
the JAX package's ``load_reference_checkpoint``; the non-reference
architectures are refused with the JAX CLI's message.  Encodes within
1e-5 (float32 sums in another order); logged metrics to their 3 digits.
"""

import dataclasses
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgc_gcn_tpu import cli as jcli
from kgc_gcn_tpu.config import Config as JaxConfig
from kgc_gcn_tpu.data.batching import make_banks as jax_make_banks
from kgc_gcn_tpu.data.dataset import load_dataset as jax_load_dataset
from kgc_gcn_tpu.data.graph import build_graph as jax_build_graph
from kgc_gcn_tpu.models import build_model as jax_build_model
from kgc_gcn_tpu.train.loop import Trainer as JaxTrainer
from kgc_gcn_tpu.utils import torch_import as jti

from kgc_gcn_torch import cli
from kgc_gcn_torch.config import Config
from kgc_gcn_torch.convert import (
    has_conv_bias, jax_leaf_names, model_params, params_from_numpy)
from kgc_gcn_torch.data.batching import make_banks
from kgc_gcn_torch.data.dataset import load_dataset
from kgc_gcn_torch.data.graph import build_graph
from kgc_gcn_torch.data.toy import write_toy
from kgc_gcn_torch.models import build_model
from kgc_gcn_torch.train.checkpoint import load_checkpoint
from kgc_gcn_torch.train.loop import Trainer, evaluate
from kgc_gcn_torch.utils import torch_import as pti
from test_torch_common import jax_leaves, port_cfg, port_toy, randomize

FLAGS = ["--gcn_in_dim", "8", "--gcn_out_dim", "16", "--k_w", "4", "--k_h",
         "4", "--num_filter", "4", "--kernel_size", "3", "--device", "cpu"]
ENC_TOL = 1e-5


def _jax_side(tmp_path, conv_bias: bool, conve_bias: bool,
              measure: float = 0.375):
    """Toy on disk; a JAX MGCN + ConvE with randomized weights, BN
    statistics and entity bias (and the optional biases); its reference
    checkpoint at ``tmp_path/ref.ckpt`` (with ``measure``)."""
    data = str(tmp_path / "data")
    write_toy(data)
    ds = jax_load_dataset("Toy", data)
    graph = jax_build_graph(ds.train_triples, ds.num_entity, ds.num_relation)
    cfg = JaxConfig(dataset="Toy", gcn_in_dim=8, gcn_out_dim=16, k_w=4, k_h=4,
                    num_filter=4, kernel_size=3, bias=conve_bias)
    model = jax_build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                            e_pad=graph.e_pad)
    params, state = model.init(jax.random.PRNGKey(5))
    params, state = randomize(params, state, np.random.default_rng(5))
    if conv_bias:
        params = dataclasses.replace(params, conv=dataclasses.replace(
            params.conv, bias=jnp.linspace(-0.5, 0.5, 16, dtype=jnp.float32)))
    path = str(tmp_path / "ref.ckpt")
    jti.save_reference_checkpoint(path, params, state, graph, measure=measure)
    return data, path, cfg, ds, graph, model


def _test_metrics(caplog) -> dict:
    line = [r.getMessage() for r in caplog.records
            if "Test metrics" in r.getMessage()][-1]
    return {k: float(v) for k, v in (kv.split(": ") for kv in line.split(
        "metrics: ")[1].strip().split("; "))}


@pytest.mark.parametrize("conv_bias,conve_bias", [
    (False, False), (True, False), (True, True)],
    ids=["no_bias", "conv_bias", "both_biases"])
def test_cli_serves_a_jax_written_reference_checkpoint(tmp_path, caplog,
                                                       conv_bias, conve_bias):
    data, path, jcfg, jds, jgraph, jmodel = _jax_side(tmp_path, conv_bias,
                                                      conve_bias)
    with caplog.at_level(logging.INFO):
        assert cli.main(["--dataset", "Toy", "--data_dir", data,
                         "--experiments_dir", str(tmp_path / "exp"),
                         "--do_test", "--restore_torch", path] + FLAGS) == 0
    got = _test_metrics(caplog)
    assert any("Imported reference checkpoint" in r.getMessage()
               and "0.375" in r.getMessage() for r in caplog.records)
    jparams, jstate, measure = jti.load_reference_checkpoint(path, jgraph)
    assert measure == 0.375
    want = JaxTrainer(jcfg, jmodel, jgraph, jax_make_banks(jds)).evaluate(
        jparams, jstate, "test", mark="Test")
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-3), k    # log: 3 digits
    saved = Config.from_json(str(tmp_path / "exp" / "Toy" / "params.json"))
    assert saved.bias == conve_bias                   # the checkpoint's

    # in process: the imported model's encode against the JAX encode
    ds = load_dataset("Toy", data)
    graph = build_graph(ds.train_triples, ds.num_entity, ds.num_relation)
    port = build_model(saved, ds.num_entity, ds.num_relation, ds.num_edge,
                       e_pad=graph.e_pad)
    sd, _ = pti.load_reference_checkpoint(path, graph)
    pti.apply_reference_state_dict(port, sd)
    assert has_conv_bias(port) == conv_bias
    # the imported JAX tree flattens in the port's leaf order, bias included
    assert list(jax_leaves(jparams)) == jax_leaf_names(saved, conv_bias)[0]
    want_ent, want_rel, _ = jmodel.encode(jparams, jstate, jgraph)
    with torch.no_grad():
        ent, rel = port.eval().encode(graph)
    np.testing.assert_allclose(ent.numpy(), np.asarray(want_ent),
                               rtol=ENC_TOL, atol=ENC_TOL)
    np.testing.assert_allclose(rel.numpy(), np.asarray(want_rel),
                               rtol=ENC_TOL, atol=ENC_TOL)


def test_training_continues_from_an_import_with_fresh_moments(tmp_path):
    """``--do_train --restore_torch``: the checkpoint's measure is the best
    so far, the optimizer starts fresh, and the bias leaf trains and is
    saved in JAX leaf order."""
    data, path, *_ = _jax_side(tmp_path, conv_bias=True, conve_bias=False)
    exp = tmp_path / "exp"
    assert cli.main(["--dataset", "Toy", "--data_dir", data,
                     "--experiments_dir", str(exp), "--do_train",
                     "--max_epoch", "1", "--batch_size", "64",
                     "--restore_torch", path] + FLAGS) == 0
    recs = [json.loads(x) for x in
            (exp / "Toy" / "metrics.jsonl").read_text().splitlines()]
    assert recs[0]["restored_best"] == 0.375
    assert recs[1]["best_mrr"] >= 0.375
    # the same import, a fresh trainer: its Adam state is zero, count 0
    cfg = Config.from_json(str(exp / "Toy" / "params.json"))
    ds = load_dataset("Toy", data)
    graph = build_graph(ds.train_triples, ds.num_entity, ds.num_relation)
    port = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                       e_pad=graph.e_pad)
    pti.apply_reference_state_dict(port, pti.load_reference_checkpoint(
        path, graph)[0])
    trainer = Trainer(cfg, port, graph, make_banks(ds))
    names = jax_leaf_names(cfg, conv_bias=True)[0]
    assert names.index("conv.bias") == names.index("conv.bn.bias") + 1
    assert [p.data_ptr() for p in trainer.params] == [
        p.data_ptr() for p in model_params(port, cfg)]
    assert trainer.opt_state.count == 0
    assert all(not m.any() for m in trainer.opt_state.mu)


@pytest.mark.parametrize("then", ["serve", "resume"])
def test_a_run_trained_from_an_import_restores_with_its_bias(tmp_path, caplog,
                                                             then):
    """A run trained from an import with ``conv1.bias`` saves a
    ``conv.bias`` leaf that ``params.json`` does not record;
    ``--restore_dir`` reads it back all the same: served (``--do_test``,
    the metrics of the saved weights, bias included) or trained on
    (``--do_train``, its Adam moments with the bias's)."""
    # measure 0: the first validation improves on it and writes last.ckpt
    data, path, *_ = _jax_side(tmp_path, conv_bias=True, conve_bias=False,
                               measure=0.0)
    exp = str(tmp_path / "exp")
    base = ["--dataset", "Toy", "--data_dir", data, "--experiments_dir", exp,
            "--batch_size", "64"] + FLAGS
    assert cli.main(base + ["--do_train", "--max_epoch", "1",
                            "--restore_torch", path]) == 0
    run = str(tmp_path / "exp" / "Toy")
    cfg = Config.from_json(run + "/params.json")
    sd, _, opt = load_checkpoint(run, cfg, with_opt_state=True)
    assert "conv.bias" in sd and len(opt.mu) == len(jax_leaf_names(
        cfg, conv_bias=True)[0])
    ds = load_dataset("Toy", data)
    graph = build_graph(ds.train_triples, ds.num_entity, ds.num_relation)
    port = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                       e_pad=graph.e_pad)
    port.conv.set_bias(sd["conv.bias"])
    port.load_state_dict(sd)
    with caplog.at_level(logging.INFO):
        if then == "serve":
            assert cli.main(base + ["--do_test", "--restore_dir", run]) == 0
            got = _test_metrics(caplog)
            want = evaluate(cfg, port.eval(), graph, make_banks(ds), "test")
            for k, v in want.items():
                assert got[k] == pytest.approx(v, abs=1e-3), k
        else:
            assert cli.main(base + ["--do_train", "--max_epoch", "1",
                                    "--restore_dir", run]) == 0
            assert "conv.bias" in load_checkpoint(run, cfg)[0]


def test_jax_reads_the_port_written_reference_checkpoint(toy, toy_cfg,
                                                         tmp_path):
    """The port's ``save_reference_checkpoint`` of a model with the conv
    bias, read by the JAX package's ``load_reference_checkpoint``: every
    leaf equal; the edge table crosses through the reference order."""
    ds, jgraph, _ = toy
    cfg = toy_cfg.replace(bias=True)
    jmodel = jax_build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                             e_pad=jgraph.e_pad)
    params, state = jmodel.init(jax.random.PRNGKey(2))
    params, state = randomize(params, state, np.random.default_rng(2))
    _, pgraph, _ = port_toy()
    port = build_model(port_cfg(cfg), ds.num_entity, ds.num_relation,
                       ds.num_edge, e_pad=jgraph.e_pad)
    port.load_state_dict(params_from_numpy(jax_leaves(params),
                                           jax_leaves(state)))
    port.conv.set_bias(torch.arange(32, dtype=torch.float32) / 64)
    path = str(tmp_path / "last.ckpt")
    pti.save_reference_checkpoint(path, port, pgraph, measure=0.25)
    blob = torch.load(path, weights_only=True)
    assert "conv1.ent_bn.num_batches_tracked" in blob["state_dict"]
    got_p, got_s, measure = jti.load_reference_checkpoint(path, jgraph)
    assert measure == 0.25
    want_p = jax_leaves(params)
    for name, v in jax_leaves(got_p).items():
        if name == "conv.bias":
            np.testing.assert_array_equal(v, np.arange(32) / 64)
        elif name == "edge_embeddings":   # padding rows come back zero
            real = jgraph.inb.e_real
            np.testing.assert_array_equal(v[:, :real], want_p[name][:, :real])
        else:
            np.testing.assert_array_equal(v, want_p[name], err_msg=name)
    for name, v in jax_leaves(got_s).items():
        np.testing.assert_array_equal(v, jax_leaves(state)[name], name)


@pytest.mark.parametrize("flags", [
    ["--model", "rgcn", "--decoder", "distmult", "--num_bases", "2"],
    ["--decoder", "distmult"], ["--num_layers", "2"]])
def test_non_reference_architectures_are_refused_as_in_jax(tmp_path, flags):
    data, path, *_ = _jax_side(tmp_path, conv_bias=False, conve_bias=False)
    argv = ["--dataset", "Toy", "--data_dir", data, "--do_test",
            "--restore_torch", path, "--gcn_in_dim", "8", "--gcn_out_dim",
            "16", "--k_w", "4", "--k_h", "4", "--num_filter", "4",
            "--kernel_size", "3"] + flags
    with pytest.raises(ValueError) as want:
        jcli.main(argv + ["--experiments_dir", str(tmp_path / "j")])
    with pytest.raises(ValueError) as got:
        cli.main(argv + ["--experiments_dir", str(tmp_path / "p"),
                         "--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "reference architecture only" in str(got.value)
