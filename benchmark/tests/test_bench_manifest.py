"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by name."""

import json
import re

import pytest

from conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MAN = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in MAN["workloads"]}
E2E = {m["name"]: m for m in MAN["end_to_end"]}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_size():
    assert set(MAN) == KEYS
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (REPO / p).is_dir()
    assert len(MAN["command"]) <= 32 and all(one_line(w) for w in MAN["command"])
    for word in MAN["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MAN["paths"])


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries_have_just_their_keys(section, keys):
    assert 1 <= len(MAN[section]) <= 24
    for entry in MAN[section]:
        assert set(entry) == keys, entry
        assert NAME.match(entry["name"]) and one_line(entry["why"])


def test_metric_entries():
    e2e_keys = {"name", "unit", "better", "bound", "source"}
    pl_keys = {"name", "unit", "better", "source", "layer", "moves"}
    assert 1 <= len(MAN["end_to_end"]) <= 16 and "setup_s" in E2E
    assert 1 <= len(MAN["per_layer"]) <= 128
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == e2e_keys
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == pl_keys
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(m["layer"])
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(CELLS)


def test_names_unique_and_cells_sound():
    assert len(CELLS) == len(MAN["workloads"])
    configs = {c["name"] for c in MAN["configs"]}
    assert len(configs) == len(MAN["configs"])
    pairs = {(w["config"], w["traffic"]) for w in MAN["workloads"]}
    assert len(pairs) == len(CELLS)
    assert {w["config"] for w in MAN["workloads"]} == configs
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert all(w["chips"] in (1, 4) for w in MAN["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def _reports(metric, cell):
    if "workloads" in metric:
        return cell in metric["workloads"]
    return True


def test_moves_and_workloads_agree():
    for m in MAN["per_layer"]:
        moved = E2E[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert _reports(moved, cell), (m["name"], cell)
    for cell in CELLS:
        e2e = [m for m in MAN["end_to_end"] if _reports(m, cell)]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(cell in m.get("workloads", [cell])
                   for m in MAN["per_layer"])


def test_configs_are_files_under_paths():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
        body = json.loads((REPO / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert one_line(c["source"]) and len(c["reduced"]) <= 16


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_named_file_exists(cell):
    from benchmark.lib import cells
    c = cells.cell(cell)
    assert (BENCH / "drivers" / f"{c.kind}.py").is_file()
    assert (BENCH / "reference" / f"{c.config_name}.py").is_file()
    assert (BENCH / "lib" / "counts" / f"{c.config_name}.py").is_file()
    for m in c.per_layer:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    assert set(c.limits) and all(isinstance(v, float) for v in c.limits.values())
