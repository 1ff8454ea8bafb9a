"""A cell and everything it names, found by name under the benchmark's
folder: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``drivers/<kind>.py`` (the traffic file's ``driver``), ``limits/<cell>.json``
(the limits of the numbers that decide ``correct``),
``reference/<config>.py`` (the plain reference), ``lib/counts/<config>.py``
(the work of a step or pass) and ``metrics/<metric>.py`` (one reader per
per-layer metric).  Adding a cell, a configuration, a traffic mix, a
metric or a kind of window adds files; none is edited."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import List

BENCH = Path(__file__).resolve().parents[1]


def manifest(bench: Path = BENCH) -> dict:
    return json.loads((bench.parent / "BENCHMARK.json").read_text())


def load_file(path: Path, name: str):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: List[dict]      # the manifest's metrics this cell reports
    per_layer: List[dict]
    bench: Path

    @property
    def kind(self) -> str:
        return self.traffic["driver"]

    def driver(self):
        return load_file(self.bench / "drivers" / f"{self.kind}.py",
                         f"benchmark_driver_{self.kind}")

    def reference(self):
        return load_file(self.bench / "reference" / f"{self.config_name}.py",
                         f"benchmark_reference_{self.config_name}")

    def counts(self):
        return load_file(self.bench / "lib" / "counts" / f"{self.config_name}.py",
                         f"benchmark_counts_{self.config_name}")

    def reader(self, metric: str):
        return load_file(self.bench / "metrics" / f"{metric}.py",
                         "benchmark_metric_" + metric.replace(".", "_"))


def _reports(metric: dict, cell: str, moves_ok: bool) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return moves_ok


def cell(name: str, bench: Path = BENCH) -> Cell:
    m = manifest(bench)
    found = [w for w in m["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    read = lambda *p: json.loads(bench.joinpath(*p).read_text())
    e2e = [x for x in m["end_to_end"] if _reports(x, name, True)]
    names = {x["name"] for x in e2e}
    per = [x for x in m["per_layer"]
           if _reports(x, name, x["moves"] in names)]
    return Cell(name, w["chips"], w["config"], read("configs",
                                                    f"{w['config']}.json"),
                w["traffic"], read("traffic", f"{w['traffic']}.json"),
                read("limits", f"{name}.json"), e2e, per, bench)
