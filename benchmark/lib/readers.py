"""What a per-layer metric's reader reads, and the arithmetic the readers
share.  A reader is ``metrics/<name>.py`` with ``read(ctx)``, returning the
metric's value, or None where the run gave it nothing to read (the metric
is then left out of the result line)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from benchmark.lib import roofline
from benchmark.lib.trace import Summary


@dataclass
class Context:
    kind: str                      # the window's driver: train | eval
    card: str                      # torch.cuda.get_device_name()
    data_setup_s: float            # the program's data layer, host clock
    unit_flops: float              # operations of one step or pass
    untraced_units: int            # steps or passes of the untraced stretch
    untraced_s: float              # its host-clock seconds
    calls: Dict[str, list]         # Kernels field -> [(bytes, ops)] a unit
    trace: Optional[Summary] = None
    traced_units: int = 0          # steps or passes under the profiler
    counters: Dict[str, int] = field(default_factory=dict)  # launches there


def mfu(ctx: Context, kind: str) -> Optional[float]:
    """% of the card's float32 peak that the untraced stretch's counted
    operations took."""
    p = roofline.peaks(ctx.card)
    if ctx.kind != kind or p is None or not ctx.untraced_s:
        return None
    rate = ctx.unit_flops * ctx.untraced_units / ctx.untraced_s
    return 100.0 * rate / p["fp32_flops"]


def idle(ctx: Context, kind: str) -> Optional[float]:
    """% of the profiled stretch in which no operation ran on the device."""
    t = ctx.trace
    if ctx.kind != kind or t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.wall_s)


def launches_per_unit(ctx: Context, kind: str) -> Optional[float]:
    t = ctx.trace
    if ctx.kind != kind or t is None or not t.launches:
        return None
    return t.launches / ctx.traced_units


def kernel_share(ctx: Context, kind: str, counter: str,
                 names) -> Optional[float]:
    """% of a kernel's roofline over its calls in the profiled stretch:
    Σ bound / Σ device time of the kernels named by ``names``.  The calls
    are the configuration's plan (``lib/counts``) times the units, and
    must equal the wrapper's launch counter ``counter`` there."""
    t = ctx.trace
    plan = ctx.calls.get(counter)
    if ctx.kind != kind or t is None or not plan:
        return None
    if ctx.counters.get(counter) != len(plan) * ctx.traced_units:
        return None
    device_s, _ = t.device_time(names)
    bound = [roofline.bound_s(ctx.card, b, o) for b, o in plan]
    if device_s <= 0 or None in bound:
        return None
    return 100.0 * sum(bound) * ctx.traced_units / device_s
