"""The control of each kind of cell fails the cell's own comparison: the
plain reference in the program's place with TF32 products (the precision
below the configurations' float32), and the half_batch fault planted in
it, decided by ``compare.decide`` under the cell's limits, at a toy size on
the CPU, and on the card at a small size where there is one."""

import pytest
import torch

from benchmark.lib import cells, compare

SEEDS = (11, 12, 13)


@pytest.fixture
def control():
    from benchmark import control as module
    return module


def _fails(readings: dict, limits: dict) -> bool:
    over = [k for k in limits if not readings[k] <= limits[k]]
    return bool(over) and not compare.decide(readings, limits)


@pytest.mark.parametrize("cell", ["mgcn_conve_toy.train.toy",
                                  "rgcn_basis_toy.train.toy"])
def test_training_control_fails(control, toy_bench, cell):
    c = cells.cell(cell, toy_bench)
    for seed in SEEDS:
        r = control.train_readings(c, seed, "cpu")
        assert _fails(r["tf32"], c.limits), r
        assert _fails(r["half_batch"], c.limits), r


def test_eval_control_fails(control, toy_bench):
    c = cells.cell("mgcn_conve_toy.eval.toy", toy_bench)
    for seed in SEEDS:
        r = control.eval_readings(c, seed, "cpu")
        assert _fails(r["tf32"], c.limits), r


def test_control_prints_its_verdicts(control, toy_bench, monkeypatch,
                                     capsys):
    import json
    find = cells.cell
    monkeypatch.setattr(cells, "cell", lambda name: find(name, toy_bench))
    control.main(["--workload", "rgcn_basis_toy.train.toy", "--seeds", "11",
                  "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] == {"tf32": False, "half_batch": False}, line


@pytest.mark.cuda
def test_training_control_fails_on_the_card(control, toy_bench):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    c = cells.cell("mgcn_conve_toy.train.toy", toy_bench)
    r = control.train_readings(c, SEEDS[0], "cuda")
    assert _fails(r["tf32"], c.limits), r
