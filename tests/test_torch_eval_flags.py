"""The evaluation flags in the port against the JAX package: per-relation
metrics (``--per_relation``: kgc_gcn_torch/ops/ranking.py,
train/loop.py:evaluate_per_relation, cli.py:write_per_relation) and
warm-start embeddings (``--init_embeddings``:
models/common.py:init_embeddings_from_npz, cli.py).

Weights come from the JAX model's init with randomized BN statistics and
entity bias, carried across by convert.py.  Tolerances: per-relation sums
and metrics 1e-5 (float32 or float64 sums in another order of the same
ranks; the ranks themselves are equal), NaN in the same places; the
per-relation file's rounded values 2e-5 (each rounded to 5 digits in its
package); warm-start tables bit-equal (a copy); error texts equal.
"""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgc_gcn_tpu import cli as jax_cli
from kgc_gcn_tpu.data.toy import write_toy
from kgc_gcn_tpu.models.common import (
    init_embeddings_from_npz as jax_init_embeddings)
from kgc_gcn_tpu.ops.ranking import (
    combine_head_tail_by_rel as jax_combine_by_rel,
    corpus_from_per_rel as jax_corpus_from_per_rel,
    rank_metric_sums_by_rel as jax_sums_by_rel)
from kgc_gcn_tpu.train import loop as jloop

from kgc_gcn_torch import cli
from kgc_gcn_torch.data.dataset import load_dataset
from kgc_gcn_torch.models.common import init_embeddings_from_npz
from kgc_gcn_torch.ops.ranking import (
    combine_head_tail_by_rel, corpus_from_per_rel, rank_metric_sums_by_rel)
from kgc_gcn_torch.serve import Predictor
from kgc_gcn_torch.train.loop import evaluate, evaluate_per_relation
from test_torch_common import jax_and_port_models, jax_leaves, port_toy

TOL = 1e-5
FILE_TOL = 2e-5
KEYS = ("count", "mr", "mrr", "hits@1", "hits@3", "hits@10")
# narrow widths for the CLI runs on Toy
SMALL = ["--gcn_in_dim", "8", "--gcn_out_dim", "32", "--k_w", "4", "--k_h",
         "8", "--num_filter", "4", "--kernel_size", "3"]


def close_nan(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=TOL,
                               atol=TOL, equal_nan=True, err_msg=what)


def test_per_relation_sums_and_combination_match_jax():
    """Sums over the forward relation (reverse ids fold onto it), then the
    two directions averaged with NaN where a relation has no queries."""
    rng = np.random.default_rng(0)
    n_rel = 5
    ranks = rng.integers(1, 40, size=(2, 64))
    rels = rng.integers(0, 2 * n_rel - 2, size=(2, 64))
    rels[rels % n_rel == 3] = 0                # relation 3 has no queries
    mask = np.ones(64, np.float32)
    got, want = [], []
    for r, rel in zip(ranks, rels):
        w = jax_sums_by_rel(jnp.asarray(r), jnp.asarray(rel), jnp.asarray(mask),
                            n_rel)
        g = rank_metric_sums_by_rel(torch.from_numpy(r), torch.from_numpy(rel),
                                    n_rel)
        assert sorted(g) == sorted(w)
        for k in w:
            close_nan(g[k].numpy(), w[k], k)
        got.append({k: v.numpy() for k, v in g.items()})
        want.append({k: np.asarray(v) for k, v in w.items()})
    per, want_per = combine_head_tail_by_rel(*got), jax_combine_by_rel(*want)
    assert list(per) == list(want_per) == list(KEYS)
    for k in KEYS:
        close_nan(per[k], want_per[k], k)
    assert np.isnan(per["mrr"][3]) and per["count"][3] == 0
    assert corpus_from_per_rel(per) == jax_corpus_from_per_rel(want_per)


@pytest.mark.parametrize("model_name", ["mgcn", "rgcn"])
def test_evaluate_per_relation_matches_jax(toy, toy_cfg, model_name):
    """The test split's per-relation table against JAX
    ``Trainer.evaluate_per_relation``, and its count-weighted mean against
    the corpus metrics of ``evaluate``."""
    cfg = toy_cfg.replace(model=model_name, decoder=(
        "conve" if model_name == "mgcn" else "distmult"), num_bases=3,
        eval_batch_size=5)
    model, params, state, port = jax_and_port_models(toy, cfg, seed=9)
    _, jgraph, jbanks = toy
    _, pgraph, pbanks = port_toy()
    want = jloop.Trainer(cfg, model, jgraph, jbanks).evaluate_per_relation(
        params, state, "test")
    got = evaluate_per_relation(port.cfg, port, pgraph, pbanks, "test")
    assert list(got) == list(want) == list(KEYS)
    for k in KEYS:
        close_nan(got[k], want[k], k)
    assert int(got["count"].sum()) == pbanks["test_tail"].n_queries
    corpus = evaluate(port.cfg, port, pgraph, pbanks, "test")
    for k, v in corpus_from_per_rel(got).items():
        assert v == pytest.approx(corpus[k], abs=1e-5), k


def _trained_run(tmp_path):
    """A port MGCN + ConvE trained one epoch on Toy through the CLI on the
    CPU: (data dir, run dir)."""
    data = str(tmp_path / "data")
    write_toy(data)
    exp = str(tmp_path / "exp")
    assert cli.main(["--dataset", "Toy", "--data_dir", data,
                     "--experiments_dir", exp, "--do_train", "--max_epoch",
                     "1", "--batch_size", "64", "--device", "cpu"]
                    + SMALL) == 0
    return data, str(tmp_path / "exp" / "Toy")


def test_cli_per_relation_writes_the_jax_layout(tmp_path, caplog):
    """``--do_test --per_relation`` on one checkpoint in both CLIs: the same
    per_relation.json rows, and the logged test metrics from that table."""
    data, run = _trained_run(tmp_path)
    out = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        caplog.clear()
        argv = ["--dataset", "Toy", "--data_dir", data, "--restore_dir", run,
                "--experiments_dir", str(tmp_path / name), "--do_test",
                "--per_relation"] + (["--device", "cpu"] if name == "port"
                                     else [])
        with caplog.at_level(logging.INFO):
            assert main(argv) == 0
        with open(tmp_path / name / "Toy" / "per_relation.json") as f:
            rows = json.load(f)
        line = next(r.getMessage() for r in caplog.records
                    if "Test metrics" in r.getMessage())
        out[name] = rows, line
    (rows, line), (want_rows, want_line) = out["port"], out["jax"]
    assert [list(r) for r in rows] == [list(r) for r in want_rows]
    for r, w in zip(rows, want_rows):
        assert (r["relation"], r["count"]) == (w["relation"], w["count"])
        for k in KEYS[1:]:
            assert (r[k] is None) == (w[k] is None), k
            if r[k] is not None:
                assert r[k] == pytest.approx(w[k], abs=FILE_TOL), k
    got_m = dict(kv.split(": ") for kv in line.split("metrics: ")[1].strip()
                 .split("; "))
    want_m = dict(kv.split(": ") for kv in want_line.split("metrics: ")[1]
                  .strip().split("; "))
    for k, v in want_m.items():      # the log's 3 digits
        assert float(got_m[k]) == pytest.approx(float(v), abs=1e-3), k
    assert sum(r["count"] for r in rows) == len(
        load_dataset("Toy", data).test_triples)


def _tables(tmp_path, name, **arrays):
    path = str(tmp_path / f"{name}.npz")
    np.savez(path, **arrays)
    return path


def test_init_embeddings_matches_jax(toy, toy_cfg, tmp_path):
    """Both tables, or one, replace the model's parameters as in JAX; the
    rest stays as it was."""
    _, params, state, port = jax_and_port_models(toy, toy_cfg, seed=10)
    rng = np.random.default_rng(11)
    ent = rng.normal(size=port.entity_embedding.shape).astype(np.float32)
    rel = rng.normal(size=port.relation_embedding.shape).astype(np.float32)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    for arrays in (dict(entity_embedding=ent),
                   dict(entity_embedding=ent, relation_embedding=rel)):
        path = _tables(tmp_path, "-".join(arrays), **arrays)
        want = jax_leaves(jax_init_embeddings(params, path))
        init_embeddings_from_npz(port, path)
        for k, v in port.state_dict().items():
            if k in want:
                np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
            if k not in arrays:
                torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_init_embeddings_refuses_with_the_jax_texts(toy, toy_cfg, tmp_path):
    """A wrong shape, an ``export_tables`` file (encoded tables, not
    parameters) and a file with neither key raise the JAX package's
    errors."""
    ds, pgraph, _ = port_toy()
    _, params, _, port = jax_and_port_models(toy, toy_cfg, seed=12)
    pred = Predictor(port.cfg, port, pgraph, ds.entity2id, ds.relation2id)
    cases = [_tables(tmp_path, "shape",
                     entity_embedding=np.zeros((3, 8), np.float32)),
             pred.export_tables(str(tmp_path / "export.npz")),
             _tables(tmp_path, "neither", other=np.zeros(2))]
    for path in cases:
        with pytest.raises(ValueError) as want:
            jax_init_embeddings(params, path)
        with pytest.raises(ValueError) as got:
            init_embeddings_from_npz(port, path)
        assert str(got.value) == str(want.value)


def test_cli_init_embeddings_warm_starts_then_trains(tmp_path, caplog):
    """``--init_embeddings`` loads the tables after init and before
    training (one epoch from them on the CPU) and refuses an
    ``export_tables`` file before any training."""
    data = str(tmp_path / "data")
    write_toy(data)
    base = ["--dataset", "Toy", "--data_dir", data, "--max_epoch", "1",
            "--batch_size", "64", "--device", "cpu"] + SMALL
    ent = np.full((load_dataset("Toy", data).num_entity, 8), 0.5, np.float32)
    path = _tables(tmp_path, "warm", entity_embedding=ent)
    with caplog.at_level(logging.INFO):
        assert cli.main(base + ["--do_train", "--experiments_dir",
                                str(tmp_path / "a"), "--init_embeddings",
                                path]) == 0
    assert any("Initialized embedding tables" in r.getMessage()
               for r in caplog.records)
    bad = _tables(tmp_path, "exported", entity_embeddings=ent)
    with pytest.raises(ValueError, match="has none of entity_embedding"):
        cli.main(base + ["--do_train", "--experiments_dir",
                         str(tmp_path / "b"), "--init_embeddings", bad])
