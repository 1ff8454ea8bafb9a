"""``lib/spans.py`` on hand-made stretches: device time by the span that
launched it (on any thread), idle gaps by the span open when they began,
work outside every span, and a stretch whose spans do not number its units;
``lib/trace.py:summarize`` with and without the spans in the stream."""

import json
from types import SimpleNamespace as NS

import pytest
import torch

from benchmark.lib import spans
from benchmark.lib.trace import summarize

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def ev(name, dev, a, b, id=0, user=False):
    return NS(name=name, device_type=dev, time_range=NS(start=a, end=b),
              id=id, is_user_annotation=user)


def us(x):
    return pytest.approx(x * 1e-6, abs=1e-12)


# one training step on thread 1; autograd's device thread launches the
# backward's kernel (id 3) while kgc/backward is open on thread 1
STEP = [
    ev("kgc/step", CPU, 0, 100),
    ev("kgc/encode", CPU, 5, 25), ev("aten::mul", CPU, 6, 12),
    ev("cudaLaunchKernel", CPU, 7, 8, id=1), ev("mul_kernel", CUDA, 10, 30, id=1),
    ev("kgc/backward", CPU, 40, 90),
    ev("cudaLaunchKernel", CPU, 50, 51, id=3), ev("bwd_kernel", CUDA, 52, 80, id=3),
    ev("cudaLaunchKernel", CPU, 95, 96, id=4), ev("step_kernel", CUDA, 96, 99, id=4),
    ev("kgc/step", CUDA, 10, 99, user=True),     # a device-side annotation
]


def test_a_step_by_span_also_from_another_thread():
    s = spans.reduce(STEP, "step", 1)
    assert s.device_s["encode"] == us(20)
    assert s.device_s["backward"] == us(28)      # launched on thread 2
    assert s.device_s["step"] == us(3)           # in the step, in no child
    assert s.busy_s == us(51) and s.covered() == 1.0
    # the host closed kgc/encode at 25, before its kernel ended at 30
    assert s.idle_s == {"step": us(22), "backward": us(16)}
    assert s.host_s["step"] == us(100) and s.instances == {
        "step": 1, "encode": 1, "backward": 1}
    assert s.per_unit_ms("device_s", "backward") == pytest.approx(0.028)
    assert s.per_unit_ms("device_s", "optimizer") is None


def test_a_gap_that_begins_inside_metric_sync_and_work_outside():
    events = [
        ev("kgc/eval_pass", CPU, 0, 100),
        ev("kgc/rank", CPU, 10, 40),
        ev("cudaLaunchKernel", CPU, 20, 21, id=7), ev("cmp", CUDA, 30, 65, id=7),
        ev("kgc/metric_sync", CPU, 45, 80),
        ev("cudaMemcpyAsync", CPU, 46, 79, id=8), ev("DtoH", CUDA, 65, 66, id=8),
        ev("kgc/score", CPU, 82, 95),
        ev("cudaLaunchKernel", CPU, 83, 84, id=9), ev("gemm", CUDA, 86, 98, id=9),
        # after the pass: the window's own work, in no span
        ev("cudaLaunchKernel", CPU, 120, 121, id=10), ev("fill", CUDA, 122, 124,
                                                          id=10),
        ev("cudaMemsetAsync", CPU, 130, 131, id=11),      # its set is lost
        ev("memset", CUDA, 132, 133, id=12),
    ]
    s = spans.reduce(events, "eval_pass", 1)
    assert s.device_s == {"rank": us(35), "metric_sync": us(1),
                          "score": us(12), spans.OUTSIDE: us(3)}
    assert s.idle_s == {"metric_sync": us(20), "eval_pass": us(24),
                        spans.OUTSIDE: us(8)}
    assert s.busy_s == us(51)
    assert s.covered() == pytest.approx(48 / 51)
    assert s.wait_s == {"metric_sync": us(33), "eval_pass": us(33)}


def test_units_that_the_spans_do_not_number_read_nothing():
    assert spans.reduce(STEP, "step", 2) is None
    assert spans.reduce(STEP, "eval_pass", 1) is None
    plain = [e for e in STEP if not e.name.startswith("kgc/")]
    assert spans.reduce(plain, "step", 1) is None     # a program without


def test_overlapping_intervals_count_once():
    events = [
        ev("kgc/step", CPU, 0, 50), ev("kgc/optimizer", CPU, 20, 40),
        ev("cudaLaunchKernel", CPU, 1, 2, id=1), ev("a", CUDA, 10, 30, id=1),
        ev("cudaLaunchKernel", CPU, 21, 22, id=2), ev("b", CUDA, 25, 35, id=2),
    ]
    s = spans.reduce(events, "step", 1)
    assert s.device_s == {"step": us(20), "optimizer": us(5)}
    assert s.busy_s == us(25) and s.idle_s == {}


def test_summarize_with_and_without_the_spans():
    """Spans launch nothing: the same busy time, launches and device time
    by name.  The idle gaps add up to the same; a gap in which no
    operation was open (Python between operations) takes the innermost
    span's name instead."""
    events = STEP[:-1]
    plain = [e for e in events if not e.name.startswith("kgc/")]
    a, b = summarize(plain, 200e-6), summarize(events, 200e-6)
    assert (a.busy_s, a.launches, a.device_s, a.kernel_calls) == (
        b.busy_s, b.launches, b.device_s, b.kernel_calls)
    assert sum(a.idle_by_host.values()) == pytest.approx(
        sum(b.idle_by_host.values()))
    assert a.idle_by_host == {"(Python between operations)": us(38)}
    assert b.idle_by_host == {"kgc/backward": us(38)}   # midpoints 41, 88


def test_split_runs_a_toy_cell(toy_bench, capsys, monkeypatch):
    """``split.py`` (the copy beside the toy cells) on the CPU: the run's
    readings and each span's instances over the 2 profiled passes (60 tail
    and 60 head queries in batches of 16).  The port's own ``filtered_ranks``
    is put back first: a faulted evaluation run earlier in the process can
    leave its replacement in ``train/loop.py``."""
    from benchmark.lib.cells import load_file
    from kgc_gcn_torch.ops import ranking
    from kgc_gcn_torch.train import loop
    monkeypatch.setattr(loop, "filtered_ranks", ranking.filtered_ranks)
    split = load_file(toy_bench / "split.py", "benchmark_split_toy")
    assert split.main(["--workload", "mgcn_conve_toy.eval.toy", "--seed",
                       "2147483677", "--seconds", "0.2"], device="cpu") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] and out["units"] == 2
    assert out["split"]["instances"] == {
        "eval_pass": 2, "encode": 2, "score": 16, "rank": 16,
        "metric_sync": 16}
    assert set(out["split"]["host_ms"]) == set(out["split"]["instances"])
