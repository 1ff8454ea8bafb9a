"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's folder
to which a test adds cells as new files only, and the run module."""

from __future__ import annotations

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path.insert(0, str(REPO))

# toy widths (ConvE needs k_w * k_h == gcn_out_dim) and counts
TOY_WIDTHS = {"gcn_in_dim": 8, "gcn_out_dim": 32, "k_w": 4, "k_h": 8,
              "num_filter": 4, "kernel_size": 3, "batch_size": 8,
              "num_bases": 3, "num_negatives": 5}
TOY_COUNTS = {"entities": 300, "relations": 5, "train": 1500, "valid": 50,
              "test": 60}
# cell -> (configuration copied, traffic copied, the limits it borrows)
TOY_CELLS = {
    "mgcn_conve_toy.train.toy": ("mgcn_conve", "train.zipf-123k", None),
    "rgcn_basis_toy.train.toy": ("rgcn_basis", "train.zipf-15k", None),
    "mgcn_conve_toy.eval.toy": ("mgcn_conve", "eval.zipf-123k",
                                "mgcn_conve.eval.zipf-123k"),
}
# The toy training cells' own limits, of the numbers the training cell
# compares, against the float64 reference.  Over seeds 7919 x 1..8 the
# port's plain path read up to 1.5e-07 (step 1's loss), 3.5e-05 (the worst
# step's), 4.9e-07 (the worst leaf's gradient) and 2.1e-03 (change) on
# MGCN + ConvE, and 1.2e-07, 1.2e-07, 5.8e-08 and 4.9e-07 on basis R-GCN: at
# widths of 4 to 32 a leaf holds few elements, and an element whose
# gradient is zero to rounding takes a whole lr-sized Adam step.  The TF32
# control (seeds 11-13) reads a worst leaf's gradient of 9.7e-05 at the
# least, the half_batch fault 0.33; a state left unchanged reads 1.
TOY_TRAIN_LIMITS = {"loss_gap_step1": 1e-6, "loss_gap_any_step": 3e-4,
                    "grad_gap_worst_leaf": 2e-5,
                    "change_gap_worst_leaf": 3e-2}


def add_toy_cells(root: Path) -> Path:
    """A copy of the benchmark under ``root`` with the toy cells added as
    new files: a configuration, a reference and a work counter per family,
    a traffic file per kind, a limits file per cell, and their manifest
    entries.  Returns the copy's benchmark folder."""
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(bench): p.read_bytes()
              for p in bench.rglob("*") if p.is_file()}
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    for cell, (conf, traffic, limits) in TOY_CELLS.items():
        toy_conf, kind = f"{conf}_toy", traffic.split(".")[0]
        c = json.loads((bench / "configs" / f"{conf}.json").read_text())
        c["port"].update({k: v for k, v in TOY_WIDTHS.items()
                          if k in c["port"]})
        (bench / "configs" / f"{toy_conf}.json").write_text(json.dumps(c))
        for sub in ("reference", "lib/counts"):
            shutil.copy(bench / sub / f"{conf}.py",
                        bench / sub / f"{toy_conf}.py")
        t = json.loads((bench / "traffic" / f"{traffic}.json").read_text())
        t["counts"] = TOY_COUNTS
        if kind == "eval":
            t["eval_batch_size"] = 16
        (bench / "traffic" / f"{kind}.toy.json").write_text(json.dumps(t))
        (bench / "limits" / f"{cell}.json").write_text(
            (bench / "limits" / f"{limits}.json").read_text() if limits
            else json.dumps(TOY_TRAIN_LIMITS))
        man["workloads"].append({"name": cell, "config": toy_conf,
                                 "traffic": f"{kind}.toy", "chips": 1,
                                 "why": "toy"})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    after = {p.relative_to(bench): p.read_bytes()
             for p in bench.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items()), "a file was edited"
    return bench


@pytest.fixture(autouse=True)
def few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def toy_bench(tmp_path_factory) -> Path:
    return add_toy_cells(tmp_path_factory.mktemp("toy"))


@pytest.fixture(scope="session")
def run_module():
    spec = importlib.util.spec_from_file_location("benchmark_run",
                                                  BENCH / "run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
