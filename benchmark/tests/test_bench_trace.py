"""The profiler reductions on a hand-made stretch: device busy as the union
of intervals, launches, kernel time by name, idle gaps by host operation."""

from types import SimpleNamespace as NS

import torch

from benchmark.lib.readers import Context, idle, kernel_share, launches_per_unit
from benchmark.lib.trace import summarize

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def ev(name, dev, a, b):
    return NS(name=name, device_type=dev, time_range=NS(start=a, end=b))


EVENTS = [
    ev("aten::mm", CPU, 0, 45), ev("cudaLaunchKernel", CPU, 1, 2),
    ev("chunk_sums<float>", CUDA, 10, 20), ev("row_fixup", CUDA, 15, 25),
    ev("aten::mul", CPU, 50, 90), ev("cudaLaunchKernel", CPU, 51, 52),
    ev("gemm", CUDA, 60, 70),
]


def test_union_launches_and_gaps():
    s = summarize(EVENTS, wall_s=100e-6)
    assert abs(s.busy_s - 25e-6) < 1e-12          # [10, 25] and [60, 70]
    assert s.launches == 2
    t, n = s.device_time(("chunk_sums", "row_fixup"))
    assert abs(t - 20e-6) < 1e-12 and n == 2
    assert list(s.idle_by_host) == ["aten::mm"]    # the gap 25..60, mid 42.5
    assert abs(s.idle_by_host["aten::mm"] - 35e-6) < 1e-12
    assert s.breakdown()["device_ops"][0][0] in ("chunk_sums<float>",
                                                 "row_fixup", "gemm")


def test_readers_on_the_stretch():
    card = "NVIDIA H100 80GB HBM3"
    ctx = Context("train", card, 0.0, 0.0, 1, 1.0,
                  {"seg_sum": [(3.35e12 * 5e-6, 0)]},
                  summarize(EVENTS, 100e-6), traced_units=2,
                  counters={"seg_sum": 2})
    assert abs(idle(ctx, "train") - 75.0) < 1e-9
    assert launches_per_unit(ctx, "train") == 1.0
    # two calls of a 5 us bound against 20 us of K1's device time
    assert abs(kernel_share(ctx, "train", "seg_sum",
                            ("chunk_sums", "row_fixup")) - 50.0) < 1e-9
    assert kernel_share(ctx, "eval", "seg_sum", ("chunk_sums",)) is None
    ctx.counters = {"seg_sum": 3}                  # calls disagree: no reading
    assert kernel_share(ctx, "train", "seg_sum", ("chunk_sums",)) is None
