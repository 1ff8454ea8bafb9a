"""Tracing and throughput helpers (the port's ``kgc_gcn_tpu/utils/
profiling.py``).

  * ``trace(logdir, steps)``: a context manager around
    ``torch.profiler.profile`` that writes one gzip-compressed Chrome-JSON
    trace into ``logdir`` (``<host>_<pid>.<time>.pt.trace.json.gz``,
    readable by TensorBoard's profiler plugin, Perfetto or
    ``chrome://tracing`` once unpacked), with the card's activity when a
    card is present and without stacks or shapes.  The profiler holds every
    event in host memory until it writes, so the trace is bounded: the
    caller calls the yielded profiler's ``step()`` after each step, and the
    trace records the first ``steps`` steps (all of a shorter context);
    the JAX package's XProf trace takes the whole context;
  * ``span(name)``: the span ``kgc/<name>`` on the profiler's host
    timeline while a ``torch.profiler`` records (``--profile_dir``, a
    profiled stretch of the benchmark), on the clock of the card's events,
    so that the device work launched inside it, and the device's idle
    gaps, can be put down to it; otherwise one shared null context, after
    a single check of a flag.  The span is a ``RecordFunction`` of the
    function scope, as an ATen operation's: a user-scope
    ``record_function`` would also leave a device-side copy of each span
    among the card's events, which reductions of the device's intervals
    would count as device time.  ``train/loop.py`` opens spans at layer
    boundaries only: ``step`` (a step's batch gather and ``train_step``),
    ``encode`` (the forward; remat's recompute falls in ``backward``),
    ``decode`` (the decoder and the scoring product), ``loss`` (the
    ``fused`` loss scores too), ``backward`` (also the launches of
    autograd's device thread), ``allreduce`` (a mesh's collectives),
    ``optimizer``; ``eval_pass``, ``score`` and ``rank`` (of a query
    batch) and ``metric_sync`` (the host waiting for metric sums);
  * ``host_reads``: how many times the hot paths blocked the host on a
    device value (the epoch's loss, each evaluation batch's metric sums,
    the per-relation tables, metric sums summed over a data group); a
    plain count, always on;
  * ``StepTimer``: steps/s and edges/s per device, with the JAX package's
    contract (``update`` after a host sync, the first interval excluded;
    ``add`` credits a span timed elsewhere).
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# Steps a trace records: enough for a per-kernel breakdown, while the
# events of a whole epoch at the published sizes would hold host memory
# in the gigabytes until the trace is written.
TRACE_STEPS = 50


@contextlib.contextmanager
def trace(logdir: str, steps: int = TRACE_STEPS
          ) -> Iterator[torch.profiler.profile]:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with warnings.catch_warnings():
        # no warm-up step: a context of one step is recorded too
        warnings.simplefilter("ignore")
        schedule = torch.profiler.schedule(wait=0, warmup=0, active=steps,
                                           repeat=1)
    with torch.profiler.profile(
            activities=activities, schedule=schedule,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir, use_gzip=True)) as prof:
        yield prof


_OFF = contextlib.nullcontext()

# Blocking reads of a device value by the host on the hot paths.
host_reads = 0


def span(name: str):
    """The span ``kgc/<name>`` while a profiler records; otherwise the
    shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast("kgc/" + name)


class StepTimer:
    """Wall-clock throughput over training steps.

    ``update`` must be called after a true host sync (for example
    ``float(loss)``); the first interval is set-up and excluded."""

    def __init__(self, edges_per_step: int, n_chips: int = 1):
        self.edges_per_step = edges_per_step
        self.n_chips = max(1, n_chips)
        self._t0: Optional[float] = None
        self.steps = 0
        self.seconds = 0.0

    def update(self, n_steps: int = 1) -> None:
        now = time.perf_counter()
        if self._t0 is not None:
            self.seconds += now - self._t0
            self.steps += n_steps
        self._t0 = now

    def add(self, seconds: float, n_steps: int) -> None:
        """Credit a span timed elsewhere (one epoch, without validation)."""
        self.seconds += seconds
        self.steps += n_steps

    @property
    def steps_per_s(self) -> float:
        return self.steps / self.seconds if self.seconds else 0.0

    @property
    def edges_per_s_per_chip(self) -> float:
        return self.steps_per_s * self.edges_per_step / self.n_chips
