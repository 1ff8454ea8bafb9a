"""The training window: a closed loop of the port's training steps, each
step following the last, through ``Trainer.train_epoch`` ->
``Trainer.train_step`` (1-vs-all) or the ``NegativeSamplingTrainer``.

Set-up builds the data, the model with the benchmark's weights and one
trainer; drives that trainer through its first ``CHECK_STEPS`` steps
through ``train_epoch`` on rows that all differ (the window's own call and
feed), keeping each step's loss, each leaf's first clipped gradient (from
Adam's first moment after one step) and each leaf's change after the last;
then warms up.  The window runs epochs of the same trainer for
``--seconds`` and ends in a synchronize.  Once it has closed (and, with
``--trace 1``, a profiled stretch has run) the program's state is freed and
the plain reference follows the checked steps from the same inputs, in
float64.
"""

from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np
import torch

from benchmark.lib import compare, port, weights as W
from benchmark.lib.clock import log_stamps
from benchmark.lib.readers import Context
from benchmark.lib.trace import summarize

CHECK_STEPS = 3
# The reference follows the checked steps in float64, the exact answer the
# program's float32 is judged against (and the TF32 control with it).
REFERENCE_PRECISION = "float64"
WARM_STEPS = 10
TRACE_STEPS = 50      # the port's utils/profiling.py bound on a trace


class _WindowEnd(Exception):
    pass


class _Plan:
    """A ``numpy`` generator stand-in for ``epoch_batches``: each call's
    order is one fixed permutation rolled by a batch more, so that the
    first step of each call takes rows no earlier call took."""

    def __init__(self, order: np.ndarray, batch: int):
        self.order, self.batch, self.calls = order, batch, 0

    def permutation(self, n: int) -> np.ndarray:
        out = np.roll(self.order, -self.calls * self.batch)
        self.calls += 1
        return out


class _Loop:
    """Runs the trainer's epochs, each on a fresh plan of the host
    generator, until ``stop`` says so after a step; counts the steps and
    the rows with mask 1 they trained."""

    def __init__(self, trainer, host_rng):
        self.trainer, self.host_rng = trainer, host_rng
        self.epoch = 1
        self.steps = self.samples = 0

    def run(self, stop) -> None:
        tr = self.trainer
        n, b, per_epoch = tr.n_train, tr.cfg.batch_size, tr.steps_per_epoch
        in_plan = 0

        def on_step():
            nonlocal in_plan
            last = in_plan == per_epoch - 1      # the padded last batch
            self.samples += n - (per_epoch - 1) * b if last else b
            self.steps += 1
            in_plan += 1
            if stop(self):
                raise _WindowEnd

        while True:
            in_plan = 0
            try:
                tr.train_epoch(self.epoch, self.host_rng, on_step=on_step)
            except _WindowEnd:
                return
            self.epoch += 1


def _trainer(cfg, model, graph, banks):
    from kgc_gcn_torch.train.loop import Trainer
    from kgc_gcn_torch.train.negative import NegativeSamplingTrainer
    cls = (NegativeSamplingTrainer if cfg.train_mode == "negative_sampling"
           else Trainer)
    return cls(cfg, model, graph, banks)


def _norms(tensors) -> dict:
    return {k: float(torch.linalg.vector_norm(t.double()))
            for k, t in tensors.items()}


def check_order(seed: int, n_train: int) -> np.ndarray:
    """The order whose successive batches the checked steps take."""
    return np.random.default_rng([seed, 0x726F77]).permutation(n_train)


def check_rows(seed: int, n_train: int, batch: int) -> list:
    """The rows of each checked step."""
    order = check_order(seed, n_train)
    return [order[i * batch:(i + 1) * batch] for i in range(CHECK_STEPS)]


def _check_steps(trainer, model, seed, edge_tables, initial, graph):
    """The first steps through ``train_epoch``; -> (program readings, the
    rows of each step)."""
    from kgc_gcn_torch.train import optim
    b = trainer.cfg.batch_size
    plan = _Plan(check_order(seed, trainer.n_train), b)
    index = {id(p): i for i, p in enumerate(trainer.params)}
    named = {n: p for n, p in model.named_parameters() if id(p) in index}
    losses, first = [], None
    for _ in range(CHECK_STEPS):
        losses.append(trainer.train_epoch(1, plan, max_steps=1))
        if first is None:
            mu = trainer.opt_state.mu
            first = _norms({n: mu[index[id(p)]].float() / (1 - optim.B1)
                            for n, p in named.items()})
    w0 = initial()
    with torch.no_grad():
        change = _norms({n: p - (port.place_edge_table(w0[n], graph)
                                 if n in edge_tables else w0[n])
                         for n, p in named.items()})
    del w0
    return ({"loss": losses, "grad": first, "change": change},
            check_rows(seed, trainer.n_train, b))


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        fault=None) -> dict:
    """One run of a training cell; -> the driver's result (see run.py)."""
    from benchmark.lib import kg as kgmod
    conf, traffic = cell.config, cell.traffic
    ref = cell.reference()
    stamp = log_stamps()
    kg = kgmod.generate(traffic, seed)
    stamp("graph generated")
    cfg = port.config(cell, seed)
    one_vs_all = cfg.train_mode != "negative_sampling"
    _, graph, banks, data_s = port.data(kg, device,
                                        ["train"] if one_vs_all else [])
    stamp("data layer")
    dims = port.dims(kg, graph)
    leaves = ref.leaves(dims, conf["port"])
    initial = lambda: W.make(leaves, seed, device)
    edge_tables = conf.get("edge_tables", [])
    model = port.model(cfg, kg, graph, initial(), edge_tables, device)
    trainer = _trainer(cfg, model, graph, banks)
    stamp("model and trainer")
    if fault is not None:
        fault(trainer)
    prog, rows = _check_steps(trainer, model, seed, edge_tables, initial,
                              graph)
    stamp("checked steps")
    loop = _Loop(trainer, np.random.default_rng([seed, 0x706C616E]))
    loop.run(lambda lp: lp.steps >= WARM_STEPS)
    port.sync(device)
    stamp("warm-up")

    # the window
    loop.steps = loop.samples = 0
    if port.on_card(device):
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    marks = []

    def until_window_end(lp):
        now = time.perf_counter() - t0
        if now >= len(marks) + 1:
            marks.append(lp.steps)
        return now >= seconds
    loop.run(until_window_end)
    port.sync(device)
    window_s = time.perf_counter() - t0
    print("[bench] steps issued by each second of the window: "
          + " ".join(str(b - a) for a, b in zip([0] + marks, marks)),
          file=sys.stderr, flush=True)
    steps, samples = loop.steps, loop.samples
    peak = port.peak_bytes(device)

    counts = cell.counts()
    ctx = Context("train", port.card_name(device), data_s,
                  counts.train_step_flops(dims, conf["port"]), steps,
                  window_s, counts.kernel_calls(dims, conf["port"], "train"))
    breakdown = None
    if trace:
        before = port.counters()
        loop.steps = 0
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if port.on_card(device):
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            t1 = time.perf_counter()
            loop.run(lambda lp: lp.steps >= TRACE_STEPS)
            port.sync(device)
            traced_s = time.perf_counter() - t1
        ctx.trace = summarize(prof.events(), traced_s)
        ctx.traced_units = loop.steps
        ctx.counters = port.counter_deltas(before)
        breakdown = ctx.trace.breakdown()
        del prof

    process_peak = port.peak_bytes(device)
    del trainer, model, graph, banks, loop
    gc.collect()
    if port.on_card(device):
        torch.cuda.empty_cache()
    stamp("window and trace")
    want = ref.train_check(kg, initial(), rows, conf["port"], seed, device,
                           precision=REFERENCE_PRECISION)
    numbers = compare.train_numbers(prog, want)
    stamp("reference")
    print("[bench] " + compare.train_detail(prog, want) + "; readings "
          + json.dumps(numbers), file=sys.stderr, flush=True)
    return {"metrics": {"train_samples_per_s": samples / window_s,
                        "train_peak_gib": peak / 2**30},
            "attempted": steps, "failed": 0, "numbers": numbers,
            "context": ctx, "breakdown": breakdown,
            "memory_peak_bytes": process_peak, "window_start": t0,
            "window": {"seconds": window_s, "steps": steps,
                       "samples": samples}}
