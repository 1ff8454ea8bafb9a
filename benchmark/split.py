"""One traced run of a cell, as ``run.py --trace 1`` makes it, with its
profiled stretch (50 training steps or 2 ranking passes) also split by the
port's ``kgc/`` spans (``lib/spans.py``):

    python3 benchmark/split.py --workload <cell> --seed <n> --seconds <s>

Prints one JSON line: the run's per-layer metrics and ``correct``; the
stretch's host-clock ms and device busy ms a unit (step or pass) and its
idle share; and, where the program has the spans, for each span the device
ms, the idle ms (gaps that began inside it), the host ms and the host's
waits a unit, the device ms outside every span and the share of the busy
time launched inside some span (``split`` is null otherwise)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run  # noqa: E402

UNITS = {"train": ("step", "TRACE_STEPS"), "eval": ("eval_pass",
                                                    "TRACE_PASSES")}


def split_json(s) -> dict:
    from benchmark.lib import spans
    names = sorted(set(s.instances) | {spans.OUTSIDE})
    table = lambda t: {n: s.per_unit_ms(t, n) for n in names
                       if s.per_unit_ms(t, n)}
    return {"device_ms": table("device_s"), "idle_ms": table("idle_s"),
            "host_ms": table("host_s"), "wait_ms": table("wait_s"),
            "instances": s.instances, "covered": s.covered()}


def main(argv=None, device: str = "cuda") -> int:
    args = run.parse(argv)
    from benchmark.lib import cells, port, spans
    cell = cells.cell(args.workload, Path(__file__).resolve().parent)
    if device == "cuda":
        run.require_cards(cell.chips)
    port.prepare_env()
    from kgc_gcn_torch.utils.device import resolve_device
    resolve_device(device)
    driver = cell.driver()
    unit, bound = UNITS[cell.kind]
    units = getattr(driver, bound)
    found = {}
    inner = driver.summarize

    def summarize(events, wall_s):
        found["split"] = spans.reduce(events, unit, units)
        return inner(events, wall_s)

    driver.summarize = summarize
    res = driver.run(cell, args.seed, args.seconds, True, device)
    ctx = res["context"]
    line = run.result_line(cell, res, True, 0.0, {})
    s = found.get("split")
    if ctx.traced_units != units:
        s = None
    t = ctx.trace
    print(json.dumps({
        "workload": cell.name, "seed": args.seed,
        "card": port.card_name(device), "correct": line["correct"],
        "metrics": {k: v["value"] for k, v in line["metrics"].items()},
        "units": ctx.traced_units, "wall_ms": 1e3 * t.wall_s / units,
        "busy_ms": 1e3 * t.busy_s / units,
        "idle": 1.0 - t.busy_s / t.wall_s if t.wall_s else None,
        "split": split_json(s) if s is not None else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
