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
