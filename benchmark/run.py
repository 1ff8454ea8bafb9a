"""One run of one benchmark cell of the PyTorch port (``kgc_gcn_torch``) on
NVIDIA cards:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration and a traffic mix; the
traffic file names the kind of window (``drivers/<kind>.py``).  The run
makes its data and weights from ``--seed``, warms up, measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics and the profiled stretch's device time.  The numbers that
decide ``correct`` are printed beside their limits as the last lines of
standard error and as the line's last key.  Without enough cards, or with a
module of JAX or the JAX package loaded, it prints no result and exits
non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def require_cards(n: int) -> None:
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise SystemExit(f"this cell needs {n} NVIDIA card(s); torch sees "
                         f"{have}")


def _number(v):
    return v if math.isfinite(v) else str(v)


def result_line(cell, res: dict, trace: bool, setup_s: float,
                device: dict) -> dict:
    """The result's JSON object: the cell's metrics of this kind of run,
    each with its unit, and the compared numbers last."""
    from benchmark.lib import compare
    metrics = {}
    if not trace:
        values = dict(res["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(res["context"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        t = res["context"].trace
        device = dict(device, busy_s=t.busy_s if t else 0.0,
                      window_s=t.wall_s if t else 0.0)
    numbers = res["numbers"]
    line = {"correct": compare.decide(numbers, cell.limits),
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if trace and res.get("breakdown"):
        line["breakdown"] = res["breakdown"]
    line["checks"] = {k: {"value": _number(v["value"]), "limit": v["limit"]}
                      for k, v in compare.checks(numbers,
                                                 cell.limits).items()}
    return line


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             fault=None) -> dict:
    """Drive the cell's window on ``device``: the driver's result."""
    from benchmark.lib import port
    port.prepare_env()
    from kgc_gcn_torch.utils.device import resolve_device
    resolve_device(device)
    return cell.driver().run(cell, seed, seconds, trace, device, fault)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark.lib import cells, isolation
    cell = cells.cell(args.workload)
    require_cards(cell.chips)
    import torch
    print(f"[bench] imports and the card: {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr, flush=True)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    setup_s = res["window_start"] - T_START
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    line = result_line(cell, res, bool(args.trace), setup_s, device)
    bad = isolation.loaded_forbidden(sys.modules)
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for k, v in line["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
