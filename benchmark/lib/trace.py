"""Reductions of one ``torch.profiler`` stretch (CPU and CUDA activity):
device busy time as the union of the device's intervals, kernel time by
name, launches the host made, and the breakdown the result line carries
(the device operations that took most time; the idle gaps of the device,
summed by the host operation that ran meanwhile)."""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# runtime calls that launch a kernel
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
TOP = 10


@dataclass
class Summary:
    wall_s: float                       # the stretch by the host clock
    busy_s: float                       # union of device intervals
    launches: int                       # kernel launch calls of the host
    device_s: Dict[str, float] = field(default_factory=dict)  # by name
    kernel_calls: Dict[str, int] = field(default_factory=dict)
    idle_by_host: Dict[str, float] = field(default_factory=dict)

    def device_time(self, parts) -> Tuple[float, int]:
        """(seconds, instances) of the kernels whose names hold any of
        ``parts``."""
        names = [n for n in self.device_s if any(p in n for p in parts)]
        return (sum(self.device_s[n] for n in names),
                sum(self.kernel_calls[n] for n in names))

    def breakdown(self) -> dict:
        top = lambda d: [[k, v] for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.device_s),
                "idle_gaps": top(self.idle_by_host)}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _innermost(host, starts, t: float, look: int = 4096) -> str:
    """The host operation open at ``t`` that began last (the innermost of
    its thread's nest), among the ``look`` latest to begin before it."""
    i = bisect.bisect_right(starts, t)
    for a, b, name in reversed(host[max(0, i - look):i]):
        if b >= t:
            return name
    return "(Python between operations)"


def summarize(events, wall_s: float) -> Summary:
    """``events``: ``prof.events()`` of a stretch that began and ended with
    the device idle (a synchronize on both sides)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    device_s: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    launches = 0
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            dev.append((a, b))
            device_s[e.name] = device_s.get(e.name, 0.0) + (b - a) * 1e-6
            calls[e.name] = calls.get(e.name, 0) + 1
        elif e.name in LAUNCH_CALLS:
            launches += 1
        elif not e.name.startswith("ProfilerStep"):
            host.append((a, b, e.name))
    busy = _union(dev)
    host.sort()
    starts = [a for a, _, _ in host]
    idle: Dict[str, float] = {}
    for (_, end), (start, _) in zip(busy, busy[1:]):
        name = _innermost(host, starts, 0.5 * (end + start))
        idle[name] = idle.get(name, 0.0) + (start - end) * 1e-6
    return Summary(wall_s, sum(b - a for a, b in busy) * 1e-6, launches,
                   device_s, calls, idle)
