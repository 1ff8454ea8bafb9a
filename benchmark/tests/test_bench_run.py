"""Runs driven in process on the CPU, at a toy size: ``run.py``'s entry
refuses to run without a card; the toy cells, added as new files only, run
through the same lookup with ``correct`` true (the reference agrees with the
port's plain path, ``ops.kernels.PLAIN``, which a CPU tensor takes); and
with the timed path broken underneath, ``correct`` comes out false."""

import json

import pytest
import torch

from benchmark.lib import cells

SEED = 2**31 + 17


def drive(run_module, bench, cell, trace=False, fault=None):
    c = cells.cell(cell, bench)
    res = run_module.run_cell(c, SEED, 0.2, trace, "cpu", fault)
    line = run_module.result_line(c, res, trace, 1.0, {"platform": "cpu"})
    json.dumps(line)
    return res, line


def test_entry_fails_without_a_card(run_module, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        run_module.main(["--workload", "mgcn_conve.train.zipf-123k", "--seed",
                         "1", "--seconds", "1", "--trace", "0"])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cell", ["mgcn_conve_toy.train.toy",
                                  "rgcn_basis_toy.train.toy",
                                  "mgcn_conve_toy.eval.toy"])
def test_toy_cell_runs_correct(run_module, toy_bench, cell):
    res, line = drive(run_module, toy_bench, cell)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks" and line["attempted"] > 0
    assert res["context"].untraced_units > 0


def test_traced_toy_cell_has_its_readings(run_module, toy_bench):
    _, line = drive(run_module, toy_bench, "rgcn_basis_toy.train.toy", True)
    assert line["correct"]
    assert "data_setup_s" in line["metrics"]      # no device: no roofline
    assert {"busy_s", "window_s"} <= set(line["device"])


def _unchanged(trainer):
    trainer.train_step = lambda lr, *batch, scale=1.0: trainer.gradients(
        *batch)[0]


def _half_batch(trainer):
    inner = trainer.batch

    def batch(idx, mask):
        out = list(inner(idx, mask))
        at = 2 if len(out[1].shape) == 2 else 1     # 1-vs-all: (q, labels, mask)
        m = out[at].clone()
        m[m.shape[0] // 2:] = 0.0
        out[at] = m
        return tuple(out)
    trainer.batch = batch


def _one_leaf_gradient(trainer):
    """A gradient 10 % off in the entity table alone, as a wrong d_x of the
    aggregation would leave it; every other leaf is right."""
    leaf = dict(trainer.model.named_parameters())["entity_embedding"]
    leaf.register_hook(lambda g: g * 1.1)


def _answer_altered(answers):
    inner = answers.inner

    def altered(*args, **kwargs):
        ranks = inner(*args, **kwargs).clone()
        ranks[0] = ranks[0] + 7
        return ranks
    answers.inner = altered


@pytest.mark.parametrize("cell,fault", [
    ("mgcn_conve_toy.train.toy", _unchanged),
    ("mgcn_conve_toy.train.toy", _half_batch),
    ("mgcn_conve_toy.train.toy", _one_leaf_gradient),
    ("rgcn_basis_toy.train.toy", _unchanged),
    ("rgcn_basis_toy.train.toy", _half_batch),
    ("rgcn_basis_toy.train.toy", _one_leaf_gradient),
    ("mgcn_conve_toy.eval.toy", _answer_altered),
])
def test_broken_path_is_not_correct(run_module, toy_bench, cell, fault):
    _, line = drive(run_module, toy_bench, cell, fault=fault)
    assert not line["correct"], line["checks"]
