"""The port's ``kgc/`` spans (``kgc_gcn_torch/utils/profiling.py:span``) in
one ``torch.profiler`` stretch: the device time of the work launched inside
each span, the device's idle gaps by the span open when each began, and
the host's time inside each span.

* A device interval (kernel, copy, set) belongs to the innermost ``kgc/``
  span, on any host thread, whose interval holds the start of the runtime
  call that launched it; a device event and its runtime call share a
  correlation id (the event's ``id``).  Autograd launches the backward's
  kernels from its device thread while ``kgc/backward`` is open on the
  calling thread, so the spans of every thread count.
* Device time is the union of the intervals: each interval counts from
  where the intervals before it end, so the spans' device times and the
  time outside every span add up to the stretch's busy time.
* An idle gap between two busy stretches belongs to the innermost span
  open when it began.
* A span's host time is its own length (its inner spans' included); its
  waits are the calls inside it that block the host on the device (a full
  launch queue, a synchronize, a copy to the host), on any thread.

A stretch whose ``kgc/<unit>`` spans do not number its traced units (the
steps or passes it ran) gives nothing: the program lacks the spans, or they
do not frame the units."""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Optional

PREFIX = "kgc/"
OUTSIDE = "(outside every span)"
# host events that block on the device
WAITS = ("Command Buffer Full", "cudaStreamSynchronize",
         "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpyAsync")


@dataclass
class Split:
    units: int                          # steps or passes
    busy_s: float                       # union of device intervals
    device_s: Dict[str, float] = field(default_factory=dict)
    idle_s: Dict[str, float] = field(default_factory=dict)
    host_s: Dict[str, float] = field(default_factory=dict)
    wait_s: Dict[str, float] = field(default_factory=dict)
    instances: Dict[str, int] = field(default_factory=dict)

    def per_unit_ms(self, table: str, span: str) -> Optional[float]:
        """``table`` (device_s, idle_s, host_s, wait_s) of ``span`` in ms
        a unit; None where the span never opened."""
        if span not in self.instances and span != OUTSIDE:
            return None
        return 1e3 * getattr(self, table).get(span, 0.0) / self.units

    def covered(self) -> float:
        """Share of the busy time launched inside some span."""
        if self.busy_s <= 0:
            return 0.0
        return 1.0 - self.device_s.get(OUTSIDE, 0.0) / self.busy_s


class _Spans:
    """The ``kgc/`` spans of every thread, by start, each with the span
    that holds it: the innermost open at a time is the one that began last
    among those still open then.  A span that closed before that time
    holds no span still open, so the search skips to its holder."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [a for a, _, _ in self.spans]
        self.parent, stack = [], []
        for i, (a, _, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] < a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def _open(self, t: float) -> int:
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.spans[j][1] < t:
            j = self.parent[j]
        return j

    def innermost(self, t: float) -> str:
        j = self._open(t)
        return self.spans[j][2] if j >= 0 else OUTSIDE

    def holding(self, a: float, b: float):
        """The spans open over all of [a, b]."""
        out, j = [], self._open(a)
        while j >= 0:
            if self.spans[j][1] >= b:
                out.append(self.spans[j][2])
            j = self.parent[j]
        return out


def reduce(events, unit: str, units: int) -> Optional[Split]:
    """``events``: ``prof.events()`` of a stretch that began and ended with
    the device idle; ``unit``: the span that frames one unit (``step``,
    ``eval_pass``); ``units``: how many the stretch ran."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    spans, launched, dev, waits = [], {}, [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if not getattr(e, "is_user_annotation", False):
                dev.append((a, b, e.id))
        elif e.name.startswith(PREFIX):
            spans.append((a, b, e.name[len(PREFIX):]))
        else:
            if e.name.startswith("cu"):       # runtime and driver calls
                launched[e.id] = a
            if e.name in WAITS:
                waits.append((a, b))
    if units <= 0 or sum(n == unit for _, _, n in spans) != units:
        return None
    index = _Spans(spans)
    device, idle = defaultdict(float), defaultdict(float)
    host, wait = defaultdict(float), defaultdict(float)
    instances = defaultdict(int)
    for a, b, name in spans:
        host[name] += b - a
        instances[name] += 1
    for a, b in waits:
        for name in index.holding(a, b):
            wait[name] += b - a
    edge = None                       # where the busy time so far ends
    busy = 0.0
    for a, b, cid in sorted(dev):
        if edge is not None and a > edge:
            idle[index.innermost(edge)] += a - edge
        lo = a if edge is None else max(a, edge)
        if b > lo:
            t = launched.get(cid)
            device[OUTSIDE if t is None else index.innermost(t)] += b - lo
            busy += b - lo
        edge = b if edge is None else max(edge, b)
    us = lambda d: {k: v * 1e-6 for k, v in d.items()}
    return Split(units, busy * 1e-6, us(device), us(idle), us(host),
                 us(wait), dict(instances))
