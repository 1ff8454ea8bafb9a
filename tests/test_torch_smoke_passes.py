"""chip_smoke.py's per-pass device times: a pass whose kernel the profiler
did not see is reported as not measured, never as 0 µs."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("top,want,shown", [
    # both passes seen (a pass may be split over kernels of one name part)
    ([("void chunk_compose<true, 1>(...)", 50.0),
      ("void split_rows<true>(...)", 6.0), ("void split_rows<false>(...)", 0.5),
      ("at::native::reduce_kernel", 9.0)],
     (50.0, 6.5), ("50.0", "6.5")),
    # a one-pass kernel of another name: neither pass was measured
    ([("void fused_compose_kernel(...)", 160.0)], (None, None),
     ("not measured", "not measured")),
])
def test_passes_us_reports_unseen_passes_as_not_measured(smoke, monkeypatch,
                                                         top, want, shown):
    calls = []
    monkeypatch.setattr(smoke, "profile_kernels",
                        lambda fn, steps=3: (calls.append(steps),
                                             (0.0, 0.0, top, []))[1])
    got = smoke.passes_us(lambda: None, smoke.K3_PASSES)
    assert calls == [5]
    assert got == want
    assert tuple(smoke.us(v) for v in got) == shown


@pytest.mark.parametrize("top,want", [
    # the fused step's profile: K2a's two launches among the step's kernels
    ([("void (anonymous namespace)::loss_tiles_kernel<true>(...)", 65.3),
      ("(anonymous namespace)::sum_partials_kernel(float const*, int, float*)",
       1.7), ("void at::native::vectorized_elementwise_kernel", 9.0)],
     {"loss_tiles": 65.3, "sum_partials": 1.7}),
    # a step without K2a (loss_impl auto): not measured, not 0 µs
    ([("void at::native::vectorized_elementwise_kernel", 9.0)],
     {"loss_tiles": None, "sum_partials": None}),
])
def test_log_profile_gives_the_named_kernels_device_time(smoke, monkeypatch,
                                                         top, want):
    monkeypatch.setattr(smoke, "profile_kernels",
                        lambda fn, steps=3: (100.0, 76.0, top, []))
    got = smoke.log_profile("one step", lambda: None, kinds=smoke.K2A_PASSES)
    assert got["kinds_us"] == want
    assert "kinds_us" not in smoke.log_profile("one step", lambda: None)


def test_k5_time_rows_and_entry(smoke, monkeypatch):
    """K5's time rows at its three shapes and its entry of the kernels
    line: every key the line needs, each shape's profiler interval, and the
    library call that gives the plain version's result."""
    import torch

    from kgc_gcn_torch.ops.segment_max import (
        segment_max, segment_max_reference)
    monkeypatch.setattr(smoke, "time_in_turns",
                        lambda fns: {k: 1.0 + len(k) for k in fns})
    top = [("void (anonymous namespace)::segment_max_kernel<4, 4, true>"
            "(...)", 4.5)]
    monkeypatch.setattr(smoke, "profile_kernels",
                        lambda fn, steps=3: (10.0, 5.0, top, []))
    dst, indptr = smoke.csr([0, 3, 0, 40, 1, 0])
    cases = {name: (torch.randn(len(dst), 4), dst, indptr, 6)
             for name in ("wn18rr_h4", "fb15k237_h4", "powerlaw_h4")}
    e_real = {"wn18rr_h4": len(dst) - 2, "fb15k237_h4": len(dst) - 1}
    t = smoke.time_k5(segment_max, segment_max_reference, cases, e_real)
    assert sorted(t) == ["fb15k237_h4", "powerlaw_h4", "wn18rr_h4"]
    for row in t.values():
        assert row["kernel_us"] == 4.5 and row["bound_by"] == "bytes"
        assert row["library"] in ("torch.segment_reduce max",
                                  "scatter_reduce_ amax")
    assert "ms_without_padding" in t["wn18rr_h4"]
    assert "ms_without_padding" in t["fb15k237_h4"]
    assert "ms_without_padding" not in t["powerlaw_h4"]
    entry = smoke.k5_entry({"wn18rr_h4": 0.0}, t, {"rgat_train": 2})
    for key in ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        assert key in entry
    assert entry["launches"] == 2 and entry["route"] == "cuda"
    assert entry["ms"] == t["wn18rr_h4"]["ms"]
    assert sorted(entry["shapes"]) == sorted(t)
