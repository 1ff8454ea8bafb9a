"""Serving, evaluation, JAX-checkpoint load and the CLI of the port against
the JAX package (kgc_gcn_torch/{serve,cli}.py, train/{loop,checkpoint}.py).

Top-k ids are compared only where neighbouring scores differ by more than
the tolerance: torch.topk and lax.top_k order near-ties differently.
"""

import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgc_gcn_tpu.data.batching import make_banks as jax_make_banks
from kgc_gcn_tpu.data.dataset import load_dataset as jax_load_dataset
from kgc_gcn_tpu.data.graph import build_graph as jax_build_graph
from kgc_gcn_tpu.data.toy import write_toy
from kgc_gcn_tpu.models import build_model as jax_build_model
from kgc_gcn_tpu.serve import Predictor as JaxPredictor
from kgc_gcn_tpu.serve import serve_file as jax_serve_file
from kgc_gcn_tpu.train.checkpoint import save_checkpoint
from kgc_gcn_tpu.train.loop import Trainer
from kgc_gcn_tpu.train.optim import make_optimizer

from kgc_gcn_torch import cli
from kgc_gcn_torch.serve import Predictor, serve_file, serve_stream
from kgc_gcn_torch.train.checkpoint import load_checkpoint
from kgc_gcn_torch.train.loop import evaluate
from test_torch_common import (jax_and_port_models, jax_leaves, port_cfg,
                               port_toy, randomize)

SCORE_TOL = 1e-4     # logits, as in test_torch_model.py
METRIC_TOL = 1e-5


def _assert_topk_match(scores, ids, want_scores, want_ids, tol=SCORE_TOL):
    np.testing.assert_allclose(scores, want_scores, rtol=tol, atol=tol)
    for s, i, wi in zip(want_scores, ids, want_ids):
        gap = -np.diff(s) > tol
        apart = np.zeros(len(s), bool)   # the last entry's lower gap is unknown
        apart[:-1] = gap & np.concatenate([[True], gap[:-1]])
        np.testing.assert_array_equal(np.asarray(i)[apart],
                                      np.asarray(wi)[apart])


@pytest.fixture(scope="module")
def served(toy, toy_cfg):
    model, params, state, port = jax_and_port_models(toy, toy_cfg, seed=2)
    ds, jgraph, _ = toy
    pds, pgraph, _ = port_toy()
    jpred = JaxPredictor(toy_cfg, model, jgraph, params, state,
                         ds.entity2id, ds.relation2id)
    pred = Predictor(port_cfg(toy_cfg), port, pgraph, pds.entity2id,
                     pds.relation2id)
    return ds, model, params, state, port, jpred, pred


def test_top_k_with_and_without_filter(served):
    ds, *_, jpred, pred = served
    src = np.array([0, 1, 2, 7], np.int32)
    rel = np.array([0, 3, 5, 6], np.int32)
    got = pred.top_k(src, rel, k=5)
    _assert_topk_match(*got, *jpred.top_k(src, rel, k=5))

    filt = np.full((4, 8), ds.num_entity, np.int32)   # pad id n_ent is dropped
    filt[:, :2] = got[1][:, :2]
    filt[2, 2] = 11
    got_f = pred.top_k(src, rel, k=5, filter_idx=filt)
    _assert_topk_match(*got_f, *jpred.top_k(src, rel, k=5, filter_idx=filt))
    for row, banned in zip(got_f[1], filt):
        assert not set(row) & set(banned[banned < ds.num_entity])


def test_score_triples(served):
    *_, jpred, pred = served
    src, rel, obj = [0, 4, 9], [1, 2, 7], [3, 0, 11]
    np.testing.assert_allclose(pred.score_triples(src, rel, obj),
                               jpred.score_triples(src, rel, obj),
                               rtol=SCORE_TOL, atol=SCORE_TOL)


def test_serve_file_and_stream(served, tmp_path):
    ds, *_, jpred, pred = served
    ents = list(ds.entity2id)
    rels = [r for r in ds.relation2id if not r.endswith("_reverse")]
    lines = [f"{ents[i % len(ents)]}\t{rels[i % len(rels)]}" for i in range(7)]
    qf = tmp_path / "q.txt"
    qf.write_text("\n".join(lines[:3]) + "\n\n" + "\n".join(lines[3:]) + "\n")
    got = [json.loads(x) for x in serve_file(pred, str(qf), k=4, batch_size=3)]
    want = [json.loads(x) for x in jax_serve_file(jpred, str(qf), k=4,
                                                  batch_size=3)]
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert (g["subject"], g["relation"]) == (w["subject"], w["relation"])
        _assert_topk_match(
            np.array([[t["score"] for t in g["topk"]]]),
            np.array([[ds.entity2id[t["entity"]] for t in g["topk"]]]),
            np.array([[t["score"] for t in w["topk"]]]),
            np.array([[ds.entity2id[t["entity"]] for t in w["topk"]]]))

    out = [json.loads(x) for x in serve_stream(
        pred, [f"{ents[0]} {rels[0]}", f"{ents[1]} {rels[1]} head",
               "nosuch r0", "x", "quit", f"{ents[2]} {rels[0]}"], k=2)]
    assert [("topk" in o, o.get("head")) for o in out] == [
        (True, False), (True, True), (False, None), (False, None)]
    assert out[1]["topk"] == pred.query_names(ents[1], rels[1], k=2, head=True)


def test_export_tables(served, tmp_path):
    ds, *_, port, jpred, pred = served
    path = pred.export_tables(str(tmp_path / "tables.npz"))
    data = np.load(path, allow_pickle=True)
    np.testing.assert_allclose(data["entity_embeddings"],
                               np.asarray(jpred.all_ent), rtol=1e-5, atol=1e-5)
    assert data["relation_embeddings"].shape == (2 * ds.num_relation, 32)
    assert list(data["entity_names"]) == list(ds.entity2id)


def test_evaluate_matches_trainer(served, toy, toy_cfg):
    ds, model, params, state, port, *_ = served
    _, jgraph, jbanks = toy
    _, pgraph, pbanks = port_toy()
    want = Trainer(toy_cfg, model, jgraph, jbanks).evaluate(
        params, state, "test", mark="Test")
    got = evaluate(port_cfg(toy_cfg), port, pgraph, pbanks, "test", "Test")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=METRIC_TOL), k


def _write_run(tmp_path, toy_cfg):
    """A Toy corpus and a JAX run directory (params.json + npz last.ckpt from
    model.init with randomized BN stats, bf16 Adam moments, and one bf16
    model leaf), as the JAX CLI would leave them after training."""
    data_dir = str(tmp_path / "data")
    write_toy(data_dir, "Toy")
    ds = jax_load_dataset("Toy", data_dir)
    graph = jax_build_graph(ds.train_triples, ds.num_entity, ds.num_relation)
    cfg = toy_cfg.replace(moment_dtype="bfloat16")
    model = jax_build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                            e_pad=graph.e_pad)
    params, state = model.init(jax.random.PRNGKey(5))
    params, state = randomize(params, state, np.random.default_rng(5))
    opt_state = make_optimizer(cfg).init(params)
    saved = dataclasses.replace(params, decoder=dataclasses.replace(
        params.decoder, ent_bias=params.decoder.ent_bias.astype(jnp.bfloat16)))
    run = str(tmp_path / "run")
    save_checkpoint(run, {"params": saved, "state": state,
                          "opt_state": opt_state}, 0.25)
    cfg.to_json(os.path.join(run, "params.json"))
    bf16_bias = params.decoder.ent_bias.astype(jnp.bfloat16).astype(jnp.float32)
    params = dataclasses.replace(params, decoder=dataclasses.replace(
        params.decoder, ent_bias=bf16_bias))
    return data_dir, run, cfg, ds, graph, model, params, state


def test_load_jax_checkpoint(tmp_path, toy_cfg):
    *_, run, cfg, ds, graph, model, params, state = _write_run(tmp_path, toy_cfg)
    sd, measure = load_checkpoint(run, port_cfg(cfg))
    assert measure == pytest.approx(0.25)
    want = dict(jax_leaves(params))
    want.update({("conv.bn." + k[8:] if k.startswith("conv_bn.") else k): v
                 for k, v in jax_leaves(state).items()})
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "missing"), port_cfg(cfg))


def test_cli_predict_and_test_on_cpu(tmp_path, toy_cfg, capsys, caplog):
    data_dir, run, cfg, ds, graph, model, params, state = _write_run(
        tmp_path, toy_cfg)
    base = ["--dataset", "Toy", "--data_dir", data_dir, "--experiments_dir",
            str(tmp_path / "exp"), "--restore_dir", run]
    qf = tmp_path / "q.txt"
    qf.write_text("e0\tr1\ne3\tr0\ne5\tr2\n")
    capsys.readouterr()
    assert cli.main(base + ["--do_predict", "--predict_file", str(qf),
                            "--top_k", "4", "--device", "cpu"]) == 0
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    jpred = JaxPredictor(cfg, model, graph, params, state, ds.entity2id,
                         ds.relation2id)
    want = [json.loads(x) for x in jax_serve_file(jpred, str(qf), k=4)]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        ids = lambda r: [[ds.entity2id[t["entity"]] for t in r["topk"]]]
        sc = lambda r: [[t["score"] for t in r["topk"]]]
        _assert_topk_match(np.array(sc(g)), np.array(ids(g)),
                           np.array(sc(w)), np.array(ids(w)))

    with caplog.at_level(logging.INFO):
        assert cli.main(base + ["--do_test", "--device", "cpu"]) == 0
    line = next(r.getMessage() for r in caplog.records
                if "Test metrics" in r.getMessage())
    got_m = dict(kv.split(": ") for kv in line.split("metrics: ")[1].strip()
                 .split("; "))
    want_m = Trainer(cfg, model, graph, jax_make_banks(ds)).evaluate(
        params, state, "test", mark="Test")
    for k, v in want_m.items():
        assert float(got_m[k]) == pytest.approx(v, abs=1e-3), k  # log: 3 digits


def test_cli_refuses_what_it_cannot_run(tmp_path):
    base = ["--dataset", "Toy", "--experiments_dir", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli.main(base + ["--do_train", "--device", "cpu",
                         "--entity_sharded", "ring"])
    # the mesh axes need a launcher's ranks (tests/test_torch_parallel.py)
    for flags in (["--data_axis", "2"], ["--graph_axis", "2"]):
        with pytest.raises(ValueError, match="WORLD_SIZE"):
            cli.main(base + ["--do_train", "--device", "cpu"] + flags)
    with pytest.raises(ValueError, match="restore dir"):
        cli.main(base + ["--do_test", "--device", "cpu"])
    if not torch.cuda.is_available():   # the default device needs a card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(base + ["--do_test", "--restore_dir", str(tmp_path)])


@pytest.mark.parametrize("flags", [
    ["--model", "rgat", "--decoder", "transe", "--num_heads", "4"],
    ["--model", "rgcn", "--decoder", "rotate", "--num_bases", "3",
     "--train_mode", "negative_sampling"],
    ["--decoder", "complex", "--loss_impl", "fused"],
    ["--num_layers", "2", "--composition", "corr"],
    ["--edge_sample_size", "8"]])
def test_cli_trains_the_model_surface_on_the_cpu(tmp_path, flags):
    """The decoders on every family, MGCN depth with ``corr`` and the edge
    sampler train one step an epoch through the CLI on the CPU, and the
    checkpoint serves ``--do_test --per_relation``."""
    write_toy(str(tmp_path / "data"))
    base = ["--dataset", "Toy", "--data_dir", str(tmp_path / "data"),
            "--experiments_dir", str(tmp_path / "exp"), "--device", "cpu",
            "--gcn_in_dim", "8", "--gcn_out_dim", "16", "--k_w", "4",
            "--k_h", "4", "--num_filter", "4", "--kernel_size", "3"]
    assert cli.main(base + ["--do_train", "--max_epoch", "1", "--batch_size",
                            "512"] + flags) == 0
    run = tmp_path / "exp" / "Toy"
    rec = json.loads((run / "metrics.jsonl").read_text().splitlines()[-1])
    assert rec["epoch"] == 1 and np.isfinite(rec["loss"])
    assert cli.main(base + ["--do_test", "--per_relation", "--restore_dir",
                            str(run)]) == 0
    assert (run / "per_relation.json").exists()
