"""The controls of ``correct``: the plain reference put in the program's
place, computed in the precision below the configuration's (TF32 products
for float32 with TF32 off), and faults planted in the reference, each read
and decided by the cell's own comparison (``lib/compare.py:decide`` under
``limits/<cell>.json``) at the cell's own size:

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--device cuda]

Training cells read the TF32 control and the ``half_batch`` fault (half of
each batch's rows left out, the mean over the rest); evaluation cells the
TF32 control's ranks.  One JSON line per seed: for each control its
readings and ``correct`` as the cell's comparison decides it (a control
that is doing its job reads false), and the cell's limits.  The benchmark's
own runs do not run this; ``tests/test_bench_control.py`` holds it at a toy
size.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.lib import cells, compare, kg as kgmod, weights as W  # noqa: E402
from benchmark.reference import common as C  # noqa: E402


def _dims(kg) -> dict:
    return {"n_ent": kg.n_ent, "n_rel": kg.n_rel, "n_edge": kg.n_train}


def train_readings(cell, seed: int, device) -> dict:
    port = cell.config["port"]
    ref = cell.reference()
    kg = kgmod.generate(cell.traffic, seed)
    w = W.make(ref.leaves(_dims(kg), port), seed, device)
    if port["train_mode"] == "negative_sampling":
        n_train = 2 * kg.n_train
    else:
        n_train = len(C.train_index(kg.triples["train"], kg.n_rel).first_seen)
    driver = cell.driver()
    rows = driver.check_rows(seed, n_train, port["batch_size"])
    base = ref.train_check(kg, w, rows, port, seed, device,
                           precision=driver.REFERENCE_PRECISION)
    out = {}
    for name, kw in (("tf32", {"precision": "tf32"}),
                     ("half_batch", {"fault": "half_batch"})):
        got = ref.train_check(kg, w, rows, port, seed, device, **kw)
        out[name] = compare.train_numbers(got, base)
    return out


def eval_readings(cell, seed: int, device) -> dict:
    port = cell.config["port"]
    ref = cell.reference()
    kg = kgmod.generate(cell.traffic, seed)
    w = W.make(ref.leaves(_dims(kg), port), seed, device)
    driver = cell.driver()
    claimed = [torch.cat([
        C.ranks(masked, target).cpu() for _, masked, target, _ in
        ref.eval_blocks(kg, w, port, device, driver.REF_BLOCK, "tf32")])]
    reported = [C.rank_metrics(claimed[0].numpy())]
    numbers = driver.judge(ref, kg, w, port, device, claimed, reported)
    return {"tf32": dict(numbers, answers_missing=0.0)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = cells.cell(args.workload)
    read = train_readings if cell.kind == "train" else eval_readings
    for seed in args.seeds:
        readings = read(cell, seed, args.device)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": {k: compare.decide(v, cell.limits)
                                      for k, v in readings.items()},
                          "readings": readings, "limits": cell.limits}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
