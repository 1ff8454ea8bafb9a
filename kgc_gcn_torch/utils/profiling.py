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
  * ``annotate(name)``: ``torch.profiler.record_function``, a labelled span
    on the host timeline;
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


def annotate(name: str):
    return torch.profiler.record_function(name)


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

    def report(self) -> str:
        return (f"{self.steps_per_s:.1f} steps/s, "
                f"{self.edges_per_s_per_chip / 1e6:.1f} Medges/s/chip")
