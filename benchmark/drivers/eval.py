"""The evaluation window: passes of the port's filtered ranking of the test
split, ``train/loop.py:evaluate``, back to back, each encoding the graph once
and ranking every tail and head query in batches of ``eval_batch_size``.

Set-up builds the data, the test query banks and the model with the
benchmark's weights, and runs one pass.  The window runs whole passes for
``--seconds``; every answer of the window (each query's filtered rank, as
``ops/ranking.py:filtered_ranks`` hands it to ``evaluate``) is kept.  Once
the window has closed (and, with ``--trace 1``, a profiled stretch has run)
the program's state is freed and the plain reference ranks the same queries
from the same inputs; each answer is judged by the reference's scores.
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark.lib import port, weights as W
from benchmark.lib.clock import log_stamps
from benchmark.lib.readers import Context
from benchmark.lib.trace import summarize
from benchmark.reference import common as C

TRACE_PASSES = 2
REF_BLOCK = 1024


class _Answers:
    """Keeps every rank tensor ``filtered_ranks`` returns while on."""

    def __init__(self, loop_module):
        self.module = loop_module
        self.inner = loop_module.filtered_ranks
        self.kept = None

    def __enter__(self):
        def recording(*args, **kwargs):
            ranks = self.inner(*args, **kwargs)
            if self.kept is not None:
                self.kept.append(ranks)
            return ranks
        self.module.filtered_ranks = recording
        return self

    def __exit__(self, *exc):
        self.module.filtered_ranks = self.inner


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        fault=None) -> dict:
    """One run of an evaluation cell; -> the driver's result (see run.py)."""
    from kgc_gcn_torch.train import loop as port_loop
    from benchmark.lib import kg as kgmod
    conf, traffic = cell.config, cell.traffic
    ref = cell.reference()
    stamp = log_stamps()
    kg = kgmod.generate(traffic, seed)
    stamp("graph generated")
    cfg = port.config(cell, seed).replace(
        eval_batch_size=traffic["eval_batch_size"])
    _, graph, banks, data_s = port.data(kg, device, ["test_tail", "test_head"])
    stamp("data layer")
    dims = port.dims(kg, graph)
    leaves = ref.leaves(dims, conf["port"])
    model = port.model(cfg, kg, graph, W.make(leaves, seed, device),
                       conf.get("edge_tables", []), device)
    model.eval()
    due = dims["eval_queries"]
    stamp("model")

    def one_pass():
        return port_loop.evaluate(cfg, model, graph, banks, "test",
                                  mark="Test")

    with _Answers(port_loop) as answers:
        if fault is not None:
            fault(answers)
        one_pass()
        port.sync(device)
        stamp("warm-up pass")
        answers.kept = []
        passes, reported = 0, []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            reported.append(one_pass())     # ends in a host sync
            passes += 1
        port.sync(device)
        window_s = time.perf_counter() - t0
        kept, answers.kept = answers.kept, None

        counts = cell.counts()
        ctx = Context("eval", port.card_name(device), data_s,
                      counts.eval_pass_flops(dims, conf["port"]),
                      passes, window_s,
                      counts.kernel_calls(dims, conf["port"], "eval"))
        breakdown = None
        if trace:
            before = port.counters()
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if port.on_card(device):
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                t1 = time.perf_counter()
                for _ in range(TRACE_PASSES):
                    one_pass()
                port.sync(device)
                traced_s = time.perf_counter() - t1
            ctx.trace = summarize(prof.events(), traced_s)
            ctx.traced_units = TRACE_PASSES
            ctx.counters = port.counter_deltas(before)
            breakdown = ctx.trace.breakdown()
            del prof

    # every pass's answers, in bank order: the tail bank's batches, then
    # the head bank's
    per_pass = len(kept) // max(passes, 1)
    claimed = [torch.cat(kept[i * per_pass:(i + 1) * per_pass]).cpu()
               for i in range(passes)]
    missing = sum(max(0, due - len(c)) for c in claimed)
    process_peak = port.peak_bytes(device)
    del model, graph, banks, kept
    gc.collect()
    if port.on_card(device):
        torch.cuda.empty_cache()
    stamp("window and trace")
    numbers = judge(ref, kg, W.make(leaves, seed, device), conf["port"],
                    device, claimed, reported)
    stamp("reference")
    numbers["answers_missing"] = float(missing)
    return {"metrics": {"eval_queries_per_s": passes * due / window_s},
            "attempted": passes * due, "failed": missing,
            "numbers": numbers, "context": ctx, "breakdown": breakdown,
            "memory_peak_bytes": process_peak, "window_start": t0,
            "window": {"seconds": window_s, "passes": passes}}


def judge(ref, kg, weights, cfg: dict, device, claimed, reported,
          precision: str = "float32") -> dict:
    """``rank_gap`` over every pass's answers against the reference's
    scores, and ``metric_gap`` of each pass's reported metrics against the
    metrics of its own answers."""
    worst = 0.0
    distinct = {}
    for c in claimed:                       # passes that agree are judged once
        distinct.setdefault(c.numpy().tobytes(), c)
    claims = list(distinct.values())
    for lo, masked, target, spread in ref.eval_blocks(
            kg, weights, cfg, device, REF_BLOCK, precision):
        for c in claims:
            part = c[lo:lo + masked.shape[0]].to(masked.device)
            if len(part) < masked.shape[0]:
                return {"rank_gap": float("inf"), "metric_gap": float("inf")}
            gaps = C.rank_gaps(masked, target, spread, part)
            worst = max(worst, float(gaps.max()))
    metric = 0.0
    for c, rep in zip(claimed, reported):
        want = C.rank_metrics(c.numpy())
        metric = max([metric] + [abs(rep[k] - v) for k, v in want.items()])
    return {"rank_gap": worst, "metric_gap": metric}
