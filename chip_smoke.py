#!/usr/bin/env python3
"""Smoke run of kgc_gcn_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--kernels-only]

Phases, in order; any failure raises and the script exits non-zero:
  1. device: require a CUDA card, print its name and power limit;
  2. build: compile the port's CUDA kernels from kgc_gcn_torch/csrc;
  3. kernels: hold each kernel against its plain PyTorch version on the card
     at the shapes the training and serving paths give it, plus an edge case:
     K1 (segment-sum) in dst, src and rel order, at RGAT's widths 4 and 200,
     on a power-law graph at FB15k-237's counts and in that graph's rel
     order, and twice on normal values (bit-identical calls), K2a / K2b
     (fused score + BCE, forward and backward), K7 / K8
     (basis R-GCN aggregation and its backward; bit-equal on dyadic inputs,
     then real values), K5 (segment-max), K4a / K4b (the one-pass compose
     and backward products, bit-equal on any input, also ragged and
     misaligned), K3 (the stacked fused compose + segment-sum; bit-equal on
     dyadic inputs, then real values, and edge cases);
  4. timing: each kernel, its plain version and the one-call library
     equivalent or yardstick, with CUDA events, beside the least time the
     card needs (K1, K3, K5, K7, K8 also without the graph's padding edges);
  5. training: the reference model (MGCN + ConvE at full width, WN18RR
     preset and dropout, random weights from --seed) on a WN18RR-shaped
     synthetic corpus: timed steps with loss_impl fused and auto (steps/s,
     edges/s, launches per step, profile, peak memory), one kernel step
     against the same step through the plain versions, then one training
     epoch through the CLI entry point, which writes last.ckpt;
  6. serving: that checkpoint served: encode once, 512 file queries and 3
     stream queries, the filtered metrics on the test split, and the encode
     held against the same encode through the plain segment-sum;
  7. R-GCN training: BASELINE config 3 (basis R-GCN, 30 bases, DistMult,
     negative sampling with K = 64, float32, FB15k-237 preset's lr and
     dropout, random weights from --seed) on an FB15k-237-shaped synthetic
     corpus: timed steps, one kernel step against the same step through the
     plain versions (same negatives and dropout masks), then one epoch
     through the CLI, which writes last.ckpt;
  8. R-GCN serving: that checkpoint through the CLI (--do_test,
     --do_predict), and the kernel encode held against the plain encode;
  9. RGAT training: bench.py's rgat_pallas configuration (RGAT + DistMult,
     4 heads, 1-vs-all, WN18RR preset's lr and dropout, random weights from
     --seed) on the WN18RR-shaped corpus of phase 5: timed steps (steps/s,
     edges/s, launches per step K5 2 and K1 10, profile, peak memory), one
     kernel step against the same step through the plain versions, then one
     epoch through the CLI, which writes last.ckpt;
 10. RGAT serving: that checkpoint through the CLI (--do_test,
     --do_predict), the kernel encode held against the plain encode, warm
     encode and top-10 times;
 11. MGCN's aggregation schedules (ew_impl=pallas, spmm_mode stacked and
     stacked_xla) with the WN18RR preset on the corpus of phase 5: per
     schedule 50 timed steps through Trainer (launches per step asserted:
     K4a 2, K4b 2, K1 4; K3 1, K1 1; K1 2) and one kernel step against the
     same step through the plain versions; then one CLI epoch with
     --use_pallas --spmm_mode stacked, its checkpoint served through the CLI
     (--do_test, --do_predict) and its kernel encode held against the plain
     encode.
K1, K3, K7 and K8 checks use dyadic inputs, whose float32 sums are exact in
any order, so kernel and plain version must agree to the bit; K5
(segment-max, phase 3: the RGAT path's shape and edge cases), K4a and K4b
(products in the plain version's order) are exact on any input.
The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.  Nothing of JAX is imported.

--kernels-only runs phases 1-3 and K1's time rows (each with its two
passes' device times), then prints K1's entry and the last line: a quick
check of the kernels that drives no path (K1's launch counts are 0).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
# kernel vs plain on dyadic messages (multiples of 2**-8 below 2, also in
# bf16): every partial sum is exact in float32, so the two must agree to the
# bit whatever their summation order
KERNEL_TOL = 0.0
# encode through the kernel vs through the plain version, real messages:
# float32 sums in another order, through BN and tanh
TOL = 1e-5
# K2a: a float32 sum of B*N terms in another order, each from a d-term dot
# product in another order
K2_LOSS_RTOL = 1e-5
# K2b: float32 sums over B (d_ent, d_bias) or N (d_h) in another order; the
# error scales with the summands, not with the cancelling sum, so the
# absolute part is relative to the largest element
K2_GRAD_RTOL, K2_GRAD_ATOL = 1e-4, 1e-4
# kernel training step vs the same step through the plain versions (warm
# Adam state, one dropout mask): the K1 and K2 sums in another order, carried
# through one backward pass and one Adam update
STEP_LOSS_RTOL = 1e-5
STEP_RTOL, STEP_ATOL = 1e-3, 1e-3
# directions that BatchNorm cancels (bn0's scale up to eps and bias, through
# the conv into BN1): their gradient is float noise on both sides
DEGENERATE = ("decoder.bn0.scale", "decoder.bn0.bias")
# K7 / K8 on real (normal) values: float32 sums over a row's edges (K7), the
# bases (d_msg) or the columns (d_a) in another order; the absolute part is
# relative to the largest element
BASIS_RTOL, BASIS_ATOL = 1e-5, 1e-5
# K3 on real (normal) values: float32 sums over a row's edges in another
# order than the plain version's index_add_; the absolute part is relative
# to the largest element
K3_RTOL, K3_ATOL = 1e-5, 1e-5
# R-GCN and RGAT encode through the kernels vs through the plain versions,
# trained weights: float32 sums in another order
ENCODE_TOL = 1e-5
# RGAT's destination attention vectors: the destination term is the same for
# every edge of a softmax segment, so their gradient is what the leaky ReLU's
# kink leaves of per-segment sums that cancel, and it can be float noise on
# both sides (at the WN18RR shape after 53 steps it stays below 2e-12 while
# the step's largest gradient is ~6e-5).  Its absolute tolerance is relative
# to the step's largest gradient, and its Adam update, which scales noise to
# lr-sized steps, is checked finite only
RGAT_DEGENERATE = ("att_dst",)
# longest R-GCN CLI epoch the smoke runs at full size; above it the CLI
# trains on fewer triples over the same entities and relations
CLI_EPOCH_LIMIT_S = 180.0
TIMED_STEPS = 50
# WN18RR's and FB15k-237's counts (scripts/make_synth_corpus.py): entities,
# relations, train / valid / test triples
WN18RR = (40943, 11, 86835, 3000, 3000)
FB15K237 = (14541, 237, 272115, 17535, 20466)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ helpers

def write_corpus(root: str, seed: int, counts) -> None:
    """Random triples with the given (entities, relations, train, valid,
    test) counts as TSV; every entity appears in train."""
    n_ent, n_rel, n_train, n_valid, n_test = counts
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for split, n in (("train", n_train), ("valid", n_valid), ("test", n_test)):
        s = rng.integers(n_ent, size=n)
        if split == "train":
            s[:n_ent] = rng.permutation(n_ent)
        r, o = rng.integers(n_rel, size=n), rng.integers(n_ent, size=n)
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("".join(f"e{a}\tr{b}\te{c}\n" for a, b, c in zip(s, r, o)))


def bound_of(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes at the memory rate and
    float32 operations at the card's rate outside the tensor cores."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(msg: torch.Tensor, n_rows: int):
    """Segment-sum: each message, indptr entry and output element moved
    once; one add per message element."""
    e, d = msg.shape
    return bound_of(e * d * msg.element_size() + 4 * (n_rows + 1)
                    + 4 * n_rows * d, e * d)


def basis_bound(e: int, n_rows: int, d: int, nb: int, backward: bool):
    """K7: msg, a and indptr read once, out written once; 2*E*B*d
    operations.  K8: g, msg, a, indptr read, d_msg and d_a written; twice
    the operations."""
    if not backward:
        return bound_of(4 * (e * d + e * nb + n_rows + 1 + n_rows * nb * d),
                        2.0 * e * nb * d)
    return bound_of(4 * (n_rows * nb * d + 2 * e * d + 2 * e * nb + n_rows + 1),
                    4.0 * e * nb * d)


def max_bound(e: int, h: int, n_rows: int):
    """Segment-max: each logit, indptr entry and output element moved once;
    one comparison per logit."""
    return bound_of(4 * e * h + 4 * (n_rows + 1) + 4 * n_rows * h, e * h)


def ew_bound(n: int, out_bytes: int, backward: bool):
    """K4a: three float32 arrays of n elements read, one written in the out
    type; two multiplies each.  K4b: four read, two written in the out type
    and one in float32; five multiplies each."""
    if not backward:
        return bound_of(n * (12 + out_bytes), 2.0 * n)
    return bound_of(n * (20 + 2 * out_bytes), 5.0 * n)


def k3_bound(n_ent: int, n_rel_rows: int, e: int, n_rows: int, d: int):
    """K3: x, rel_all, etab, src, rel, norm and indptr read once, out
    written once; three multiplies and one add per edge element."""
    return bound_of(4 * ((n_ent + n_rel_rows + e + n_rows) * d + 3 * e
                         + n_rows + 1), 4.0 * e * d)


def k2_bound(b: int, n: int, d: int, backward: bool):
    """K2a: h, ent, bias, w read once, one scalar written; one B x d x N
    product.  K2b: the same inputs and g read, d_h, d_ent, d_bias written;
    three such products."""
    read = 4 * (b * d + n * d + n + b)
    if not backward:
        return bound_of(read + 4, 2.0 * b * d * n)
    return bound_of(read + 4 + 4 * (b * d + n * d + n), 6.0 * b * d * n)


def time_in_turns(fns: dict, n: int = 100, warmup: int = 5,
                  lead_cycles: int = 2_000_000) -> dict:
    """Median device ms per call of each function, timed with CUDA events in
    turns.  Before each call a 256 MB read evicts the 50 MB L2 cache (the
    paths read freshly computed operands from device memory) without
    leaving dirty lines behind, and a spin kernel of ``lead_cycles`` keeps the
    card busy while the host enqueues the call, so the events time the
    device's work and not the host's launch overhead."""
    flush = torch.zeros(64 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        for f in fns.values():
            f()
    events = []
    for _ in range(n):
        for name, f in fns.items():
            flush.sum()
            torch.cuda._sleep(lead_cycles)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f()
            end.record()
            events.append((name, start, end))
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for name, start, end in events:
        times[name].append(start.elapsed_time(end))
    return {name: statistics.median(v) for name, v in times.items()}


def host_ms(fn, n: int) -> float:
    """Median host wall ms of ``fn`` through to the device's completion."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def profile_kernels(fn, steps: int = 3):
    """(wall µs, device-busy µs, top kernels by device µs, top PyTorch ops by
    self device µs) per call of ``fn`` under torch.profiler; busy is 0.0 if
    the profiler saw no kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6 / steps
    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / steps)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    ops = []
    for avg in prof.key_averages():
        dev = getattr(avg, "self_device_time_total", None)
        if dev is None:
            dev = getattr(avg, "self_cuda_time_total", 0.0)
        if dev > 0 and not avg.key.startswith(("void ", "sm", "Memcpy",
                                               "Memset")):
            ops.append((avg.key, dev / steps, avg.count // steps))
    ops.sort(key=lambda kv: -kv[1])
    return wall, sum(by_name.values()), top, ops[:12]


def log_profile(what: str, fn, steps: int = 3) -> dict:
    wall, busy, top, ops = profile_kernels(fn, steps)
    if busy == 0.0:
        log(f"[profile] {what}: device time not measured (the profiler saw "
            "no kernel)")
        return {}
    log(f"[profile] {what}: wall {wall:.1f} us, device busy {busy:.1f} us, "
        f"idle {1 - busy / wall:.1%}; top kernels: "
        + "; ".join(f"{n[:90]} {t:.1f} us" for n, t in top))
    if ops:
        log(f"[profile] {what}: top ops by self device time: "
            + "; ".join(f"{n} {t:.1f} us x{c}" for n, t, c in ops))
    return {"wall_us": wall, "busy_us": busy, "idle": 1 - busy / wall}


def phase_ms(trainer, batch, lr, n: int = 10) -> dict:
    """Median host ms of one training step's phases, each ended by a
    device sync: forward + loss, backward, optimizer."""
    from kgc_gcn_torch.train import optim
    out = {"forward": [], "backward": [], "optimizer": []}
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.loss(*batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = list(torch.autograd.grad(loss, trainer.params))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        optim.step(trainer.params, grads, trainer.opt_state, trainer.cfg, lr)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, a, b in (("forward", t0, t1), ("backward", t1, t2),
                        ("optimizer", t2, t3)):
            out[k].append((b - a) * 1e3)
    return {k: statistics.median(v) for k, v in out.items()}


def dyadic(e: int, d: int, dtype, gen) -> torch.Tensor:
    return (torch.randint(-511, 512, (e, d), generator=gen) / 256).to(dtype)


def basis_case(dst, indptr, n_rows: int, d: int, nb: int, gen, real: bool):
    """K7 / K8 operands (msg (E, d), a (E, B), dst, indptr, g (n_rows, B*d))
    on the card: multiples of 2**-4 below 1 (every product and partial sum
    exact in float32), or normal values with ``real``."""
    e = dst.shape[0]
    draw = ((lambda *s: torch.randn(*s, generator=gen)) if real else
            (lambda *s: torch.randint(-15, 16, s, generator=gen) / 16))
    return (draw(e, d).cuda(), draw(e, nb).cuda(), dst.cuda(), indptr.cuda(),
            draw(n_rows, nb * d).cuda())


def csr_case(counts, d: int, dtype, gen):
    counts = torch.as_tensor(counts, dtype=torch.int64)
    dst = torch.repeat_interleave(torch.arange(len(counts)), counts)
    indptr = torch.zeros(len(counts) + 1, dtype=torch.int64)
    indptr[1:] = torch.cumsum(counts, 0)
    msg = dyadic(len(dst), d, dtype, gen)
    return (msg.cuda(), dst.int().cuda(), indptr.int().cuda(), len(counts))


def half_case(half, n_rows: int, d: int, dtype, gen, order: str = "dst"):
    """K1's operands at one direction half's shape: ``dst`` the forward's
    dst-sorted view, ``src`` the backward d_x's src-sorted view (messages
    permuted by sperm), ``rel`` the relation gradient's rel-sorted view."""
    msg = dyadic(half.dst.shape[0], d, dtype, gen).cuda()
    if order == "dst":
        return (msg, half.dst.cuda(), half.indptr.cuda(), n_rows)
    perm, ids, ptr = {"src": (half.sperm, half.s_src, half.s_indptr),
                      "rel": (half.rperm, half.r_rel, half.r_indptr)}[order]
    return (msg[perm.cuda().long()].contiguous(), ids.cuda(), ptr.cuda(),
            int(ptr.shape[0]) - 1)


def synthetic_graphs(seed: int, corpus_root: str):
    """The WN18RR-shaped corpus, written under ``corpus_root``, as a dataset
    and its graph; a graph of random triples at FB15k-237's counts; and
    in-degrees of a power law at FB15k-237's counts (row ~ rank**-1.1)."""
    from kgc_gcn_torch.data.dataset import load_dataset
    from kgc_gcn_torch.data.graph import build_graph
    write_corpus(os.path.join(corpus_root, "SYN"), seed, WN18RR)
    ds = load_dataset("SYN", corpus_root)
    graph = build_graph(ds.train_triples, ds.num_entity, ds.num_relation)
    n_fb, r_fb, e_fb = FB15K237[:3]
    rng = np.random.default_rng(seed + 1)
    fb_tri = np.stack([rng.integers(n_fb, size=e_fb),
                       rng.integers(r_fb, size=e_fb),
                       rng.integers(n_fb, size=e_fb)], axis=1)
    fb_graph = build_graph(fb_tri, n_fb, r_fb)
    rank_w = (rng.permutation(n_fb) + 1.0) ** -1.1
    power_counts = np.bincount(rng.choice(n_fb, size=e_fb,
                                          p=rank_w / rank_w.sum()),
                               minlength=n_fb)
    return ds, graph, fb_graph, power_counts


def k1_cases(ds, graph, fb_graph, power_counts, d: int, gen) -> dict:
    """K1's operands on the card, dyadic messages of width ``d`` unless
    stated, at the shapes the paths give it."""
    n_wn, n_fb = ds.num_entity, FB15K237[0]
    f32, bf16 = torch.float32, torch.bfloat16
    return {
        "wn18rr_f32": half_case(graph.inb, n_wn, d, f32, gen),
        "fb15k237_bf16": half_case(fb_graph.inb, n_fb, d, bf16, gen),
        # the backward's uses: d_x over src-sorted edges, d_rel over
        # rel-sorted edges (the K1 branch of segment_sum_few)
        "wn18rr_src_f32": half_case(graph.inb, n_wn, d, f32, gen, "src"),
        "wn18rr_rel_f32": half_case(graph.outb, n_wn, d, f32, gen, "rel"),
        "fb15k237_src_bf16": half_case(fb_graph.inb, n_fb, d, bf16, gen,
                                       "src"),
        "fb15k237_rel_bf16": half_case(fb_graph.outb, n_fb, d, bf16, gen,
                                       "rel"),
        # RGAT's widths: D 4 (the softmax denominator, and the per-edge
        # gathers' backward), D 200 (the aggregation; src order: the edge
        # message's d_h)
        "wn18rr_d4_f32": half_case(graph.inb, n_wn, 4, f32, gen),
        "wn18rr_d200_f32": half_case(graph.inb, n_wn, 200, f32, gen),
        "wn18rr_src_d200_f32": half_case(graph.inb, n_wn, 200, f32, gen,
                                         "src"),
        # power-law hubs (no padding) and FB15k-237's rel order in float32
        "fb15k237_powerlaw_f32": csr_case(power_counts, d, f32, gen),
        "fb15k237_powerlaw_bf16": csr_case(power_counts, d, bf16, gen),
        "fb15k237_rel_f32": half_case(fb_graph.outb, n_fb, d, f32, gen,
                                      "rel"),
    }


def k2_case(b: int, n: int, d: int, masked, gen):
    """h, ent, bias, row mask as the training path gives them: h after
    ReLU, entities after tanh, a small bias, padding rows masked."""
    h = torch.relu(torch.randn(b, d, generator=gen))
    ent = torch.tanh(torch.randn(n, d, generator=gen))
    bias = torch.randn(n, generator=gen) * 0.1
    w = torch.ones(b)
    w[list(masked)] = 0.0
    return [t.cuda() for t in (h, ent, bias, w)]


def assert_topk_match(scores, ids, want_scores, want_ids, tol: float) -> None:
    """Scores close; ids equal wherever neighbouring scores differ by more
    than ``tol`` (near-ties may come out in either order)."""
    torch.testing.assert_close(scores, want_scores, rtol=tol, atol=tol)
    gap = (want_scores[:, :-1] - want_scores[:, 1:]) > tol
    apart = torch.zeros_like(want_ids, dtype=torch.bool)
    apart[:, 1:-1] = gap[:, :-1] & gap[:, 1:]
    apart[:, 0] = gap[:, 0]
    if not torch.equal(ids[apart], want_ids[apart]):
        raise AssertionError("top-k ids differ between kernel and plain encode")


def check_cli_metrics(logged: dict, exact: dict, n_ent: int, what: str):
    """The CLI logs its test metrics to 3 digits (a random model's MRR over
    tens of thousands of entities prints as 0.000): they must be ``exact``,
    an evaluation of the same checkpoint, rounded; and those must be
    metrics."""
    if not (1.0 <= exact["mr"] <= n_ent and 0.0 < exact["mrr"] <= 1.0
            and all(0.0 <= v <= 1.0 for k, v in exact.items() if "hits" in k)
            and all(abs(logged[k] - v) <= 5e-4 + 1e-9
                    for k, v in exact.items())):
        raise AssertionError(f"{what}: cli metrics {logged}, evaluate {exact}")


def close_rel(got, want, rtol, atol_rel, what) -> float:
    """assert_close with the absolute part relative to max |want|; returns
    the max abs error."""
    atol = atol_rel * float(want.abs().max()) + 1e-30
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=what)
    return float((got - want).abs().max())


class Launches:
    """The launch counts of the kernel wrappers, in the order of NAMES."""

    NAMES = ("K1", "K2a", "K2b", "K7", "K8", "K5", "K3", "K4a", "K4b")

    def __init__(self, wrappers):
        self.wrappers = wrappers

    def zero(self) -> None:
        for f in self.wrappers:
            f.launches = 0

    def read(self) -> tuple:
        return tuple(f.launches for f in self.wrappers)

    @classmethod
    def show(cls, counts) -> str:
        return ", ".join(f"{k} {c}" for k, c in zip(cls.NAMES, counts))


def timed_steps(trainer, launches: Launches, per_step, what: str,
                seed: int) -> dict:
    """3 set-up steps of ``trainer``'s epoch, then TIMED_STEPS warm ones
    (steps/s, edges/s, peak memory, mean loss), each of which must launch
    ``per_step`` kernels; then a profile and the host phases of one step."""
    from kgc_gcn_torch.train import optim
    host_rng = np.random.default_rng(seed)
    trainer.train_epoch(1, host_rng, max_steps=3)      # one-time set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.zero()
    t0 = time.perf_counter()
    loss = trainer.train_epoch(1, host_rng, max_steps=TIMED_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = launches.read()
    peak = torch.cuda.max_memory_allocated()
    want = tuple(TIMED_STEPS * c for c in per_step)
    if got != want or not math.isfinite(loss):
        raise AssertionError(f"{what}: launches {Launches.show(got)}; want "
                             f"{Launches.show(want)}; loss {loss}")
    sps = TIMED_STEPS / dt
    b, device = trainer.cfg.batch_size, trainer.device
    batch = trainer.batch(torch.arange(b, device=device),
                          torch.ones(b, device=device))
    lr = optim.epoch_lr(trainer.cfg, 1)
    prof = log_profile(f"one {what} training step",
                       lambda: trainer.train_step(lr, *batch), steps=3)
    phases = phase_ms(trainer, batch, lr)
    log(f"[train] {what} step phases (host ms, each ended by a sync): "
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
    n_msgs = trainer.graph.num_messages
    log(f"[train] {what}: {TIMED_STEPS} warm steps in {dt:.3f} s = "
        f"{sps:.2f} steps/s, {sps * n_msgs:.4g} edges/s (2E+N = {n_msgs}); "
        f"mean loss {loss:.6f}; launches per step "
        + ", ".join(f"{k} {c}" for k, c in zip(Launches.NAMES, per_step) if c)
        + f"; peak memory {peak} B; an epoch of {trainer.steps_per_epoch} "
        f"steps ~ {trainer.steps_per_epoch / sps:.1f} s")
    return {"steps_per_s": sps, "edges_per_s": sps * n_msgs,
            "peak_bytes": peak, "loss": loss, **prof, "phases_ms": phases,
            "launches_per_step": dict(zip(Launches.NAMES,
                                          (c / TIMED_STEPS for c in got)))}


def same_step(trainer, batch, seed: int, launches: Launches, per_step,
              what: str, degenerate=(), cancelling=()) -> dict:
    """One kernel step of ``trainer`` against the same step through the plain
    versions, from its warm state (a copy of its model and Adam state), with
    the same batch and dropout masks: the loss within STEP_LOSS_RTOL, every
    gradient and update within STEP_RTOL and STEP_ATOL x max.  Leaves named
    in ``degenerate`` are checked finite only; a leaf whose last name is in
    ``cancelling`` has its gradient's absolute tolerance relative to the
    step's largest gradient and its update checked finite only.  Returns the
    largest errors."""
    from kgc_gcn_torch.convert import jax_leaf_names
    from kgc_gcn_torch.train import optim
    cfg = trainer.cfg
    plain = type(trainer)(cfg, copy.deepcopy(trainer.model), trainer.graph,
                          trainer.banks, plain=True)
    plain.opt_state = optim.AdamState(
        trainer.opt_state.count, [m.clone() for m in trainer.opt_state.mu],
        [v.clone() for v in trainer.opt_state.nu])
    before = [p.detach().clone() for p in trainer.params]
    lr = optim.epoch_lr(cfg, 1)
    result = {}
    for name, t in (("kernel", trainer), ("plain", plain)):
        t.generator.manual_seed(seed)
        launches.zero()
        loss = t.loss(*batch)
        grads = list(torch.autograd.grad(loss, t.params))
        optim.step(t.params, grads, t.opt_state, cfg, lr)
        result[name] = (loss.detach(), grads, launches.read())
        del loss
        torch.cuda.empty_cache()
    if result["kernel"][2] != tuple(per_step) or any(result["plain"][2]):
        raise AssertionError(f"{what} same-step launches {result['kernel'][2]}"
                             f" / {result['plain'][2]}")
    torch.testing.assert_close(result["kernel"][0], result["plain"][0],
                               rtol=STEP_LOSS_RTOL, atol=0.0,
                               msg=f"{what} step loss")
    g_max = max(float(g.abs().max()) for g in result["plain"][1])
    errs, notes = {"grad": 0.0, "update": 0.0}, []
    for i, name in enumerate(jax_leaf_names(cfg)[0]):
        gk, gp = result["kernel"][1][i], result["plain"][1][i]
        uk = trainer.params[i].detach() - before[i]
        up = plain.params[i].detach() - before[i]
        if not (torch.isfinite(gk).all() and torch.isfinite(uk).all()):
            raise AssertionError(f"{what} same step: non-finite {name}")
        if name in degenerate:
            continue
        if name.rsplit(".", 1)[-1] in cancelling:
            torch.testing.assert_close(gk, gp, rtol=STEP_RTOL,
                                       atol=STEP_ATOL * g_max,
                                       msg=f"{what} same step: grad {name}")
            notes.append(f"{name}: max abs err "
                         f"{float((gk - gp).abs().max()):.3g} of gradients up "
                         f"to {float(gp.abs().max()):.3g} (atol {STEP_ATOL} x "
                         f"the step's largest, {g_max:.3g})")
            continue
        errs["grad"] = max(errs["grad"], close_rel(
            gk, gp, STEP_RTOL, STEP_ATOL, f"{what} same step: grad {name}"))
        errs["update"] = max(errs["update"], close_rel(
            uk, up, STEP_RTOL, STEP_ATOL, f"{what} same step: update {name}"))
    if degenerate:
        notes.append(f"{', '.join(degenerate)} checked finite only")
    log(f"[train] {what} kernel step vs plain step (warm Adam, count "
        f"{trainer.opt_state.count}, the same batch and dropout masks): loss "
        f"{float(result['kernel'][0]):.8f} vs {float(result['plain'][0]):.8f}; "
        f"max abs err grads {errs['grad']:.3g}, updates {errs['update']:.3g} "
        f"(rtol {STEP_RTOL}, atol {STEP_ATOL} x max)"
        + "".join(f"; {n}" for n in notes))
    return errs


def cli_epoch(argv, run_dir: str, launches: Launches, want, what: str):
    """One training epoch through the CLI entry point, which writes
    ``run_dir``; the launches from its start to its end (the training path's)
    must equal ``want``.  Returns them and the epoch's metrics record."""
    from kgc_gcn_torch import cli
    torch.cuda.synchronize()
    launches.zero()                                    # the path starts
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        raise AssertionError(f"{what} failed")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = launches.read()                              # the path ends
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    ep = recs[-1]
    if not (ep.get("epoch") == 1 and math.isfinite(ep["loss"])
            and os.path.exists(os.path.join(run_dir, "last.ckpt"))
            and 0.0 < ep["val"]["mrr"] <= 1.0):
        raise AssertionError(f"{what}: {recs}")
    if got != tuple(want):
        raise AssertionError(f"{what}: launches {got}, want {tuple(want)}")
    log(f"[train] {what}: {seconds:.2f} s with validation (epoch {ep['sec']} "
        f"s); loss {ep['loss']}; Val {ep['val']}; launches "
        f"{Launches.show(got)}; last.ckpt written")
    return got, ep


def cli_serve(serve_args, qfile: str, n_queries: int, entity2id,
              launches: Launches, want, what: str):
    """``--do_test``, then ``--do_predict`` of the ``n_queries`` lines of
    ``qfile`` (top-10 each), through the CLI entry point; the launches of the
    two (the serving path's) must equal ``want``.  Returns them and the test
    metrics the CLI logged."""
    from kgc_gcn_torch import cli
    captured = _Capture()
    logging.getLogger().addHandler(captured)
    try:
        launches.zero()                                # the path starts
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if cli.main(serve_args + ["--do_test"]) != 0:
            raise AssertionError(f"{what} --do_test failed")
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            if cli.main(serve_args + ["--do_predict", "--predict_file", qfile,
                                      "--top_k", "10"]) != 0:
                raise AssertionError(f"{what} --do_predict failed")
        torch.cuda.synchronize()
        predict_s = time.perf_counter() - t0
        got = launches.read()                          # the path ends
    finally:
        logging.getLogger().removeHandler(captured)
    answers = [json.loads(x) for x in out.getvalue().splitlines()]
    if len(answers) != n_queries or not all(
            len(a["topk"]) == 10 and all(math.isfinite(t["score"])
                                         and t["entity"] in entity2id
                                         for t in a["topk"])
            for a in answers):
        raise AssertionError(f"{what} --do_predict: {len(answers)} answers")
    if got != tuple(want):
        raise AssertionError(f"{what}: launches {got}, want {tuple(want)}")
    test_line = [m for m in captured.lines if "Test metrics" in m][-1]
    metrics = {k: float(v) for k, v in (
        kv.split(": ") for kv in test_line.split("metrics: ")[1].strip()
        .split("; "))}
    log(f"[serve] {what} cli --do_test {test_s:.2f} s {metrics}; --do_predict "
        f"{n_queries} queries {predict_s:.2f} s (both load the corpus and build"
        f" the graph); launches {Launches.show(got)}")
    return got, metrics


def served_encode(run_dir: str, ds, graph, banks, queries, logged: dict,
                  what: str) -> dict:
    """The checkpoint the CLI trained in ``run_dir``, served in process: the
    test metrics the CLI logged against ``evaluate``, the kernel encode
    against the plain encode (ENCODE_TOL) and the top-10 of ``queries``
    from both, then warm encode and top-10 times."""
    from kgc_gcn_torch.config import Config
    from kgc_gcn_torch.models import build_model
    from kgc_gcn_torch.ops.kernels import PLAIN
    from kgc_gcn_torch.train.checkpoint import load_checkpoint
    from kgc_gcn_torch.train.loop import evaluate
    cfg = Config.from_json(os.path.join(run_dir, "params.json"))
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge)
    model.load_state_dict(load_checkpoint(run_dir, cfg)[0])
    model = model.to(graph.device).eval()
    check_cli_metrics(logged, evaluate(cfg, model, graph, banks, "test",
                                       mark="Test"), ds.num_entity, what)
    q = torch.as_tensor(queries, device=graph.device).long()
    with torch.no_grad():
        ent_k, rel_k = model.encode(graph)
        ent_p, rel_p = model.encode(graph, kernels=PLAIN)
        torch.testing.assert_close(ent_k, ent_p, rtol=ENCODE_TOL,
                                   atol=ENCODE_TOL, msg=f"{what} encode")
        torch.testing.assert_close(rel_k, rel_p, rtol=0.0, atol=0.0)
        got = torch.topk(model.decode(ent_k, rel_k, q[:, 0], q[:, 1]), 10)
        want = torch.topk(model.decode(ent_p, rel_p, q[:, 0], q[:, 1]), 10)
        assert_topk_match(got.values, got.indices, want.values, want.indices,
                          tol=1e-4)
        encode = lambda: model.encode(graph)
        top_k = lambda: torch.topk(model.decode(ent_k, rel_k, q[:, 0],
                                                q[:, 1]), 10)
        dev = time_in_turns({"encode": encode, "top_k": top_k}, n=10,
                            warmup=1, lead_cycles=10_000_000)
        rec = {"encode_max_abs_err": float((ent_k - ent_p).abs().max()),
               "encode_host_ms": host_ms(encode, 5),
               "encode_device_ms": dev["encode"],
               "top_k_host_ms": host_ms(top_k, 10),
               "top_k_device_ms": dev["top_k"]}
        log(f"[serve] {what} kernel encode vs plain encode: all_ent "
            f"max_abs_err {rec['encode_max_abs_err']:.3g} (tol {ENCODE_TOL}); "
            f"top-10 of {q.shape[0]} queries agree; warm encode "
            f"{rec['encode_host_ms']:.3f} ms host, {dev['encode']:.3f} ms "
            f"device; top-10 of a {q.shape[0]}-query batch "
            f"{rec['top_k_host_ms']:.3f} ms host, {dev['top_k']:.3f} ms device")
        log_profile(f"{what} encode", encode)
    return rec


# ------------------------------------------------------------------- phases

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-3 and K1's time rows only")
    args = ap.parse_args()

    # 1. device ---------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from kgc_gcn_torch.config import Config, dataset_preset
    from kgc_gcn_torch.data.batching import make_banks
    from kgc_gcn_torch.data.dataset import load_dataset
    from kgc_gcn_torch.data.graph import build_graph
    from kgc_gcn_torch.models import build_model
    from kgc_gcn_torch.ops.basis import (
        basis_backward, basis_backward_reference, basis_segment_sum,
        basis_segment_sum_reference)
    from kgc_gcn_torch.ops.elementwise import (
        bwd_products, bwd_products_reference, compose_msg,
        compose_msg_reference)
    from kgc_gcn_torch.ops.fused_compose import (
        fused_compose, fused_compose_reference)
    from kgc_gcn_torch.ops.fused_loss import (
        dense_grads, dense_grads_reference, dense_loss, dense_loss_reference)
    from kgc_gcn_torch.ops.kernels import PLAIN
    from kgc_gcn_torch.ops.segment_max import segment_max, segment_max_reference
    from kgc_gcn_torch.ops.segment_sum import segment_sum, segment_sum_reference
    from kgc_gcn_torch.serve import Predictor, serve_file, serve_stream
    from kgc_gcn_torch.train.checkpoint import load_checkpoint
    from kgc_gcn_torch.train.loop import Trainer, evaluate
    from kgc_gcn_torch.train.negative import NegativeSamplingTrainer
    from kgc_gcn_torch.utils.cuda_build import load_kernels
    from kgc_gcn_torch.utils.device import resolve_device

    device = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; count {torch.cuda.device_count()}")
    log(smi)
    launches = Launches((segment_sum, dense_loss, dense_grads,
                         basis_segment_sum, basis_backward, segment_max,
                         fused_compose, compose_msg, bwd_products))

    # 2. build ----------------------------------------------------------------
    kernels = load_kernels(force_build=True)
    log(f"[build] {kernels.path.name} in {kernels.build_seconds:.1f} s")
    for line in kernels.build_log.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            log("  " + line.strip())

    # 3. kernels against the plain version --------------------------------------
    gen = torch.Generator().manual_seed(args.seed)
    t0 = time.perf_counter()
    work = tempfile.TemporaryDirectory()
    corpus_root = os.path.join(work.name, "data")
    ds, graph, fb_graph, power_counts = synthetic_graphs(args.seed,
                                                         corpus_root)
    n_fb = FB15K237[0]
    log(f"[data] {ds.num_entity} entities, {ds.num_relation} relations, "
        f"{ds.num_edge} train edges (E_pad {graph.e_pad}), "
        f"{ds.num_train_queries} train queries; FB15k-237-shaped graph E_pad "
        f"{fb_graph.e_pad}; {time.perf_counter() - t0:.1f} s")

    d_in = dataset_preset("WN18RR").gcn_in_dim
    hub = torch.randint(0, 4, (1001,), generator=gen)
    hub[[0, 500, 1000]] = 0
    hub[123] = 5000
    cases = k1_cases(ds, graph, fb_graph, power_counts, d_in, gen)
    timed = list(cases)
    cases["edge_f32"] = csr_case(hub, 37, torch.float32, gen)
    cases["edge_bf16"] = csr_case(hub, 37, torch.bfloat16, gen)
    errs = {}
    for name, (msg, dst, indptr, n_rows) in cases.items():
        got = segment_sum(msg, dst, indptr, n_rows)
        want = segment_sum_reference(msg, dst, indptr, n_rows)
        torch.cuda.synchronize()
        errs[name] = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL,
                                   msg=name)
        log(f"[K1 check] {name}: E={msg.shape[0]} D={msg.shape[1]} "
            f"rows={n_rows} largest row {int((indptr[1:] - indptr[:-1]).max())}"
            f" edges; max_abs_err={errs[name]:.3g} (tol {KERNEL_TOL})")
    # normal values, whose float32 sums depend on their order: each row's
    # order is fixed, so two calls give the same bits
    msg, dst, indptr, n_rows = cases["fb15k237_powerlaw_f32"]
    real = torch.randn(msg.shape, generator=gen).to(device)
    first = segment_sum(real, dst, indptr, n_rows)
    if not torch.equal(first, segment_sum(real, dst, indptr, n_rows)):
        raise AssertionError("K1: two calls on the same inputs differ")
    k1_real_err = close_rel(first, segment_sum_reference(real, dst, indptr,
                                                         n_rows),
                            BASIS_RTOL, BASIS_ATOL, "K1 real values")
    log(f"[K1 check] fb15k237_powerlaw_f32 on normal values: two calls "
        f"bit-identical; max_abs_err vs index_add_ {k1_real_err:.3g} (rtol "
        f"{BASIS_RTOL}, atol {BASIS_ATOL} x max)")
    del real, first

    cfg0 = dataset_preset("WN18RR")
    b_main, d_out = cfg0.batch_size, cfg0.gcn_out_dim
    k2_cases = {
        "main": (k2_case(b_main, ds.num_entity, d_out, (), gen), ()),
        "edge": (k2_case(5, 1001, 37, (1, 3), gen), (1, 3)),
        "wide": (k2_case(7, 300, 300, (6,), gen), (6,)),   # two gradient windows
    }
    k2_errs = {"K2a": {}, "K2b": {}}
    for name, ((h, ent, bias, w), _) in k2_cases.items():
        n = ent.shape[0]
        base = 1.0 / n
        g = 1.0 / (float(w.sum().clamp_min(1.0)) * n)
        g_t = torch.tensor(g, device=device)
        got = dense_loss(h, ent, bias, w, base)
        want = dense_loss_reference(h, ent, bias, w, base)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=K2_LOSS_RTOL, atol=0.0,
                                   msg=f"K2a {name}")
        k2_errs["K2a"][name] = float((got - want).abs())
        got_g = dense_grads(g_t, h, ent, bias, w, base)
        want_g = dense_grads_reference(g_t, h, ent, bias, w, base)
        torch.cuda.synchronize()
        k2_errs["K2b"][name] = max(
            close_rel(a, b_, K2_GRAD_RTOL, K2_GRAD_ATOL, f"K2b {name} {what}")
            for a, b_, what in zip(got_g, want_g, ("d_h", "d_ent", "d_bias")))
        if not all(bool(torch.isfinite(t).all()) for t in got_g):
            raise AssertionError(f"K2b {name}: non-finite gradients")
        log(f"[K2 check] {name}: B={h.shape[0]} N={n} d={h.shape[1]} "
            f"masked rows {list(k2_cases[name][1])}: loss {float(got):.6g} vs "
            f"{float(want):.6g} (rtol {K2_LOSS_RTOL}); grads max_abs_err "
            f"{k2_errs['K2b'][name]:.3g} (rtol {K2_GRAD_RTOL}, atol "
            f"{K2_GRAD_ATOL} x max)")

    # K7 / K8 at BASELINE config 3's shape (FB15k-237 in-half, B 30, d 100)
    # and an edge case (empty rows, a hub row, B = 1, d 37)
    cfg3 = dataset_preset("FB15k-237", model="rgcn", decoder="distmult",
                          num_bases=30, train_mode="negative_sampling",
                          compute_dtype="float32", moment_dtype="float32",
                          seed=args.seed)
    nb3, d3 = cfg3.num_bases, cfg3.gcn_in_dim
    hub_ptr = torch.zeros(hub.shape[0] + 1, dtype=torch.int32)
    hub_ptr[1:] = torch.cumsum(hub, 0)
    hub_dst = torch.repeat_interleave(torch.arange(hub.shape[0]), hub).int()
    fb_in = fb_graph.inb
    basis_shapes = {"config3": (fb_in.dst, fb_in.indptr, n_fb, d3, nb3),
                    "edge": (hub_dst, hub_ptr, hub.shape[0], 37, 1)}
    basis_errs = {"K7": {}, "K8": {}}
    for name, (dst_, ptr_, n_rows, d, nb) in basis_shapes.items():
        for real in (False, True):
            msg, a, dd, ip, g = basis_case(dst_, ptr_, n_rows, d, nb, gen, real)
            got = basis_segment_sum(msg, a, dd, ip, n_rows)
            want = basis_segment_sum_reference(msg, a, dd, ip, n_rows)
            got_b = basis_backward(g, msg, a, dd, ip)
            want_b = basis_backward_reference(g, msg, a, dd, ip)
            torch.cuda.synchronize()
            case = f"{name}_{'real' if real else 'dyadic'}"
            if real:
                basis_errs["K7"][case] = close_rel(got, want, BASIS_RTOL,
                                                   BASIS_ATOL, f"K7 {case}")
                basis_errs["K8"][case] = max(
                    close_rel(x, y, BASIS_RTOL, BASIS_ATOL, f"K8 {case} {w}")
                    for x, y, w in zip(got_b, want_b, ("d_msg", "d_a")))
            else:
                for x, y, w in ((got, want, "K7"), (got_b[0], want_b[0], "K8 d_msg"),
                                (got_b[1], want_b[1], "K8 d_a")):
                    torch.testing.assert_close(x, y, rtol=0.0, atol=0.0,
                                               msg=f"{w} {case}")
                basis_errs["K7"][case] = 0.0
                basis_errs["K8"][case] = 0.0
            log(f"[K7/K8 check] {case}: E={msg.shape[0]} rows={n_rows} B={nb} "
                f"d={d}: K7 max_abs_err {float((got - want).abs().max()):.3g},"
                f" K8 max_abs_err d_msg "
                f"{float((got_b[0] - want_b[0]).abs().max()):.3g}, d_a "
                f"{float((got_b[1] - want_b[1]).abs().max()):.3g} (tol "
                + (f"rtol {BASIS_RTOL}, atol {BASIS_ATOL} x max)" if real
                   else "0: bit-equal)"))
            del got, want, got_b, want_b, msg, a, g
    torch.cuda.empty_cache()

    # K5 at the RGAT path's shape (the WN18RR-shaped in-half: E_pad edges,
    # H 4, normal logits with the zero-norm padding edges at -inf, as the
    # softmax masks them) and edge cases on the hub counts above (empty
    # rows 0, 500 and 1000, a 5,000-edge hub row 123): row 1 only -inf,
    # about a fifth of the other logits -inf, H 1, 5 and 40.  A max is exact
    # in any order, so kernel and plain version agree to the bit.
    n_heads = dataset_preset("WN18RR", model="rgat", num_heads=4).num_heads
    path_logits = torch.randn(graph.inb.dst.shape[0], n_heads, generator=gen)
    path_logits[graph.inb.norm == 0] = -math.inf

    def edge_logits(h):
        lg = torch.randn(hub_dst.shape[0], h, generator=gen)
        lg[torch.rand(hub_dst.shape[0], generator=gen) < 0.2] = -math.inf
        lg[int(hub_ptr[1]):int(hub_ptr[2])] = -math.inf
        return lg

    max_cases = {"wn18rr_h4": (path_logits, graph.inb.dst, graph.inb.indptr,
                               ds.num_entity)}
    for h in (1, 5, 40):
        max_cases[f"edge_h{h}"] = (edge_logits(h), hub_dst, hub_ptr,
                                   hub.shape[0])
    max_cases = {k: (lg.cuda(), dd.cuda(), ip.cuda(), n)
                 for k, (lg, dd, ip, n) in max_cases.items()}
    max_errs = {}
    for name, (lg, dd, ip, n_rows) in max_cases.items():
        got = segment_max(lg, dd, ip, n_rows)
        want = segment_max_reference(lg, dd, ip, n_rows)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0.0, atol=0.0,
                                   msg=f"K5 {name}")
        finite = torch.isfinite(want)
        max_errs[name] = float(torch.where(finite, got - want, 0.0).abs().max())
        log(f"[K5 check] {name}: E={lg.shape[0]} H={lg.shape[1]} rows={n_rows}"
            f" (empty rows {int((ip[1:] == ip[:-1]).sum())}, rows of only -inf "
            f"{int(torch.isneginf(want).all(1).sum())}): max_abs_err "
            f"{max_errs[name]:.3g} (tol 0: bit-equal, -inf where the plain "
            "version has it)")

    # K4a / K4b at the WN18RR half shape (the ew_impl=pallas path: E_pad x
    # d_in float32 operands, float32 and bf16 outputs) and an edge case whose
    # E*d is no multiple of 4, a view at a row offset that is not 16-byte
    # aligned (the scalar path).  The kernels multiply in the plain version's
    # order and round once, so they agree to the bit on any input.
    def ew_operands(e: int, d: int, offset: int = 0):
        return [torch.randn(e + offset, d, generator=gen).to(device)[offset:]
                for _ in range(4)]

    ew_cases = {"wn18rr": ew_operands(graph.inb.dst.shape[0], d_in),
                "edge_misaligned": ew_operands(1001, 37, offset=1)}
    ew_errs = {"K4a": {}, "K4b": {}}
    for name, (a, b, c, g) in ew_cases.items():
        for dt in (torch.float32, torch.bfloat16):
            case = f"{name}_{str(dt).split('.')[-1]}"
            got = compose_msg(a, b, c, dt)
            want = compose_msg_reference(a, b, c, dt)
            got_b = bwd_products(g, a, b, c, dt)
            want_b = bwd_products_reference(g, a, b, c, dt)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=0.0, atol=0.0,
                                       msg=f"K4a {case}")
            for x, y, w in zip(got_b, want_b, ("contrib", "d_rel_in",
                                                "d_etab")):
                torch.testing.assert_close(x, y, rtol=0.0, atol=0.0,
                                           msg=f"K4b {case} {w}")
            ew_errs["K4a"][case] = float((got.float() - want.float()).abs().max())
            ew_errs["K4b"][case] = max(float((x.float() - y.float()).abs().max())
                                       for x, y in zip(got_b, want_b))
            log(f"[K4 check] {case}: E={a.shape[0]} d={a.shape[1]} (16-byte "
                f"aligned: {a.data_ptr() % 16 == 0}, E*d % 4 = "
                f"{a.numel() % 4}): K4a max_abs_err {ew_errs['K4a'][case]:.3g},"
                f" K4b max_abs_err {ew_errs['K4b'][case]:.3g} (tol 0: "
                "bit-equal)")

    # K3 at the stacked WN18RR shape (both halves' 2 E_pad edges over 2N
    # rows, the 2R+1 relation rows; rows N-1 and 2N-1 hold the padding
    # edges) and an edge case on the hub counts above at d 37 (empty rows, a
    # 5,000-edge hub row): dyadic operands first (multiples of 2**-3 below
    # 1: every product and partial sum exact in float32, so bit-equal), then
    # normal values with the graph's own norms (K3_RTOL, K3_ATOL x max).
    st = graph.stacked
    n_rel_rows = 2 * ds.num_relation + 1
    n_hub = hub_dst.shape[0]
    k3_shapes = {
        "wn18rr_stacked": (st.src, st.rel, st.norm, st.dst2, st.indptr,
                           ds.num_entity, d_in),
        "edge_d37": (torch.randint(0, 40, (n_hub,), generator=gen).int(),
                     torch.randint(0, n_rel_rows, (n_hub,), generator=gen).int(),
                     None, hub_dst, hub_ptr, 40, 37)}
    k3_errs, k3_args = {}, {}
    for name, (src_, rel_, norm_, dst_, ip_, n_x, d) in k3_shapes.items():
        for real in (False, True):
            draw = ((lambda *sh: torch.randn(*sh, generator=gen)) if real else
                    (lambda *sh: torch.randint(-7, 8, sh, generator=gen) / 8))
            e = src_.shape[0]
            nm = norm_ if real and norm_ is not None else draw(e)
            args_ = [t.to(device) for t in (draw(n_x, d), src_, nm,
                                            draw(n_rel_rows, d), rel_,
                                            draw(e, d), dst_, ip_)]
            args_.append(ip_.shape[0] - 1)
            got = fused_compose(*args_)
            want = fused_compose_reference(*args_)
            torch.cuda.synchronize()
            case = f"{name}_{'real' if real else 'dyadic'}"
            if real:
                k3_errs[case] = close_rel(got, want, K3_RTOL, K3_ATOL,
                                          f"K3 {case}")
            else:
                torch.testing.assert_close(got, want, rtol=0.0, atol=0.0,
                                           msg=f"K3 {case}")
                k3_errs[case] = float((got - want).abs().max())
            k3_args[case] = args_
            counts = (ip_[1:] - ip_[:-1]).long()
            log(f"[K3 check] {case}: E={e} rows={ip_.shape[0] - 1} d={d} "
                f"relation rows {n_rel_rows} (empty rows "
                f"{int((counts == 0).sum())}, largest row {int(counts.max())}"
                f" edges): max_abs_err {k3_errs[case]:.3g} (tol "
                + (f"rtol {K3_RTOL}, atol {K3_ATOL} x max)" if real
                   else "0: bit-equal)"))

    # 4. timing -----------------------------------------------------------------
    # The graph pads each half with zero-norm edges, all in row N-1 of the
    # dst order (and in row 0 of the src order): one hub row.
    # "ms_without_padding" times the forward with those edges cut off
    # (indptr[-1] = e_real, same messages) to size that row's cost.
    timings = {}
    padded = {"wn18rr_f32": graph.inb.e_real,
              "fb15k237_bf16": fb_graph.inb.e_real,
              "wn18rr_d4_f32": graph.inb.e_real,
              "wn18rr_d200_f32": graph.inb.e_real}
    for name in timed:
        e_real = padded.get(name)
        msg, dst, indptr, n_rows = cases[name]
        dst_long, msg_f32 = dst.long(), msg.float()
        lib_out = torch.zeros(n_rows, msg.shape[1], device=device)
        fns = {
            "ms": lambda: segment_sum(msg, dst, indptr, n_rows),
            "plain_ms": lambda: segment_sum_reference(msg, dst, indptr, n_rows),
            "library_ms": lambda: lib_out.index_add_(0, dst_long, msg_f32),
        }
        if e_real is not None:
            cut = indptr.clone()
            cut[-1] = e_real
            fns["ms_without_padding"] = lambda: segment_sum(msg, dst, cut, n_rows)
        t = time_in_turns(fns)
        t["bound_ms"], t["bound_by"] = bound(msg, n_rows)
        # each pass's device µs per call: pass A chunk_sums, pass B row_fixup
        top = profile_kernels(fns["ms"], 5)[2]
        t["pass_a_us"], t["pass_b_us"] = (
            sum(us for kernel, us in top if kind in kernel)
            for kind in ("chunk_sums", "row_fixup"))
        timings[name] = t
        pad = (f"; without the {msg.shape[0] - e_real} padding edges: "
               f"{t['ms_without_padding']:.4f} ms" if e_real is not None else "")
        log(f"[K1 time] {name}: kernel {t['ms']:.4f} ms (passes A / B "
            f"{t['pass_a_us']:.1f} / {t['pass_b_us']:.1f} µs), plain "
            f"{t['plain_ms']:.4f} ms, index_add_ {t['library_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}); "
            f"{t['bound_ms'] / t['ms']:.1%} of bound{pad}")
    if args.kernels_only:
        print(json.dumps({"kernels": [k1_entry(errs, timings, {})]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # the relation gradient below the one-hot limit: one PyTorch call, the
    # float32 one-hot product or index_add_ (segment_sum_few uses index_add_)
    for name, g_ in (("wn18rr", graph), ("fb15k237", fb_graph)):
        half = g_.outb.to(device)
        n_seg = int(half.r_indptr.shape[0]) - 1
        vals = dyadic(half.rel.shape[0], d_in, torch.float32, gen).to(device)
        ids = half.rel.long()
        onehot = lambda: (ids[None, :] == torch.arange(
            n_seg, device=device)[:, None]).float() @ vals
        index_add = lambda: torch.zeros(n_seg, d_in, device=device).index_add_(
            0, ids, vals)
        # dyadic values: both sums are exact, so they agree to the bit
        torch.testing.assert_close(onehot(), index_add(), rtol=0.0, atol=0.0)
        t = time_in_turns({"onehot": onehot, "index_add": index_add}, n=50)
        timings[f"few_sum_{name}"] = t
        log(f"[few-segment sum] {name}: {n_seg} x {half.rel.shape[0]} x {d_in}: "
            f"one-hot product {t['onehot']:.4f} ms, index_add_ "
            f"{t['index_add']:.4f} ms")

    # K5 at the RGAT path's shape; the library call is one
    # torch.segment_reduce over the CSR lengths where it gives the plain
    # version's result (-inf on empty rows), else scatter_reduce_("amax")
    lg, dd, ip, n_rows = max_cases["wn18rr_h4"]
    lengths = (ip[1:] - ip[:-1]).long()
    seg_reduce = lambda: torch.segment_reduce(lg, "max", lengths=lengths,
                                              axis=0, unsafe=True)
    want = segment_max_reference(lg, dd, ip, n_rows)
    if torch.equal(seg_reduce(), want):
        library, library_name = seg_reduce, "torch.segment_reduce max"
    else:
        idx = dd.long()[:, None].expand(-1, lg.shape[1])
        library, library_name = (lambda: torch.full_like(want, -math.inf)
                                 .scatter_reduce_(0, idx, lg, "amax"),
                                 "scatter_reduce_ amax")
    cut = ip.clone()
    cut[-1] = graph.inb.e_real
    t = time_in_turns({
        "ms": lambda: segment_max(lg, dd, ip, n_rows),
        "plain_ms": lambda: segment_max_reference(lg, dd, ip, n_rows),
        "library_ms": library,
        "ms_without_padding": lambda: segment_max(lg, dd, cut, n_rows),
    })
    t["bound_ms"], t["bound_by"] = max_bound(lg.shape[0], lg.shape[1], n_rows)
    t["library"] = library_name
    timings["k5_wn18rr_h4"] = t
    log(f"[K5 time] wn18rr_h4 (E {lg.shape[0]}, H {lg.shape[1]}, rows "
        f"{n_rows}): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
        f"{library_name} {t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} "
        f"ms ({t['bound_by']}), {t['bound_ms'] / t['ms']:.1%} of bound; "
        f"without the {lg.shape[0] - graph.inb.e_real} padding edges "
        f"{t['ms_without_padding']:.4f} ms")
    log_profile("K5 at the RGAT path's shape",
                lambda: segment_max(lg, dd, ip, n_rows), steps=5)

    for name in ("main", "edge"):
        (h, ent, bias, w), _ = k2_cases[name]
        b, d = h.shape
        n = ent.shape[0]
        base = 1.0 / n
        g_t = torch.tensor(1.0 / (b * n), device=device)
        entT = ent.T
        t = time_in_turns({
            "K2a": lambda: dense_loss(h, ent, bias, w, base),
            "K2a_plain": lambda: dense_loss_reference(h, ent, bias, w, base),
            "K2b": lambda: dense_grads(g_t, h, ent, bias, w, base),
            "K2b_plain": lambda: dense_grads_reference(g_t, h, ent, bias, w, base),
            "addmm": lambda: torch.addmm(bias, h, entT),
        })
        t["K2a_bound"], t["K2a_bound_by"] = k2_bound(b, n, d, False)
        t["K2b_bound"], t["K2b_bound_by"] = k2_bound(b, n, d, True)
        timings[f"k2_{name}"] = t
        if name == "main":
            log_profile("K2a at the main shape",
                        lambda: dense_loss(h, ent, bias, w, base), steps=5)
            log_profile("K2b at the main shape",
                        lambda: dense_grads(g_t, h, ent, bias, w, base), steps=5)
        log(f"[K2 time] {name} (B {b}, d {d}, N {n}): K2a {t['K2a']:.4f} ms, "
            f"plain {t['K2a_plain']:.4f} ms, bound {t['K2a_bound']:.4f} ms "
            f"({t['K2a_bound_by']}), {t['K2a_bound'] / t['K2a']:.1%} of bound; "
            f"K2b {t['K2b']:.4f} ms, plain {t['K2b_plain']:.4f} ms, bound "
            f"{t['K2b_bound']:.4f} ms ({t['K2b_bound_by']}), "
            f"{t['K2b_bound'] / t['K2b']:.1%} of bound; yardstick "
            f"addmm(bias, h, ent.T) {t['addmm']:.4f} ms")

    # K7 / K8 at config 3: "ms_without_padding" cuts the 269 zero-norm
    # padding edges of row N-1 off (indptr[-1] = e_real, same operands).
    # Yardsticks (no one PyTorch call computes either function): K7,
    # index_add_ of the pre-built (E, B*d) expansion; K8, the two einsums on
    # a pre-gathered sel = g[dst].  The basis contraction that follows K7 in
    # the encoder, (N, B*d) @ (B*d, d_out), is timed beside them.
    msg, a, dd, ip, g = basis_case(fb_in.dst, fb_in.indptr, n_fb, d3, nb3, gen,
                                   real=True)
    e3 = msg.shape[0]
    cut = ip.clone()
    cut[-1] = fb_in.e_real
    expansion = (msg[:, None, :] * a[:, :, None]).reshape(e3, -1)
    sel = g[dd.long()].view(e3, nb3, d3)
    lib_out = torch.zeros(n_fb, nb3 * d3, device=device)
    dst_long = dd.long()
    basis_w = torch.randn(nb3 * d3, cfg3.gcn_out_dim, generator=gen).to(device)
    agg = basis_segment_sum(msg, a, dd, ip, n_fb)
    t = time_in_turns({
        "K7": lambda: basis_segment_sum(msg, a, dd, ip, n_fb),
        "K7_plain": lambda: basis_segment_sum_reference(msg, a, dd, ip, n_fb),
        "K7_yardstick": lambda: lib_out.index_add_(0, dst_long, expansion),
        "K7_without_padding": lambda: basis_segment_sum(msg, a, dd, cut, n_fb),
        "K8": lambda: basis_backward(g, msg, a, dd, ip),
        "K8_plain": lambda: basis_backward_reference(g, msg, a, dd, ip),
        "K8_yardstick": lambda: (torch.einsum("ebd,eb->ed", sel, a),
                                 torch.einsum("ebd,ed->eb", sel, msg)),
        "K8_without_padding": lambda: basis_backward(g, msg, a, dd, cut),
        "basis_matmul": lambda: agg @ basis_w,
    }, n=50)
    t["K7_bound"], t["K7_bound_by"] = basis_bound(e3, n_fb, d3, nb3, False)
    t["K8_bound"], t["K8_bound_by"] = basis_bound(e3, n_fb, d3, nb3, True)
    timings["basis_config3"] = t
    log_profile("K7 at config 3", lambda: basis_segment_sum(msg, a, dd, ip, n_fb),
                steps=5)
    log_profile("K8 at config 3", lambda: basis_backward(g, msg, a, dd, ip),
                steps=5)
    for key, what in (("K7", "index_add_ of the pre-built expansion"),
                      ("K8", "two einsums on a pre-gathered sel")):
        log(f"[{key} time] config 3 (E {e3}, N {n_fb}, B {nb3}, d {d3}): "
            f"kernel {t[key]:.4f} ms, plain {t[f'{key}_plain']:.4f} ms, "
            f"yardstick ({what}) {t[f'{key}_yardstick']:.4f} ms, bound "
            f"{t[f'{key}_bound']:.4f} ms ({t[f'{key}_bound_by']}), "
            f"{t[f'{key}_bound'] / t[key]:.1%} of bound; without the "
            f"{e3 - fb_in.e_real} padding edges {t[f'{key}_without_padding']:.4f}"
            " ms")
    log(f"[basis contraction] (N {n_fb}, {nb3 * d3}) @ ({nb3 * d3}, "
        f"{cfg3.gcn_out_dim}) float32: {t['basis_matmul']:.4f} ms "
        f"({2 * n_fb * nb3 * d3 * cfg3.gcn_out_dim / t['basis_matmul'] / 1e9:.1f}"
        " TFLOP/s)")
    del msg, a, g, expansion, sel, lib_out, agg, cut
    torch.cuda.empty_cache()

    # K4a / K4b at the WN18RR half shape, float32 and bf16 outputs; no one
    # PyTorch call computes either function (no library time)
    a, b, c, g = ew_cases["wn18rr"]
    bf16 = torch.bfloat16
    t = time_in_turns({
        "K4a": lambda: compose_msg(a, b, c),
        "K4a_plain": lambda: compose_msg_reference(a, b, c),
        "K4a_bf16": lambda: compose_msg(a, b, c, bf16),
        "K4a_bf16_plain": lambda: compose_msg_reference(a, b, c, bf16),
        "K4b": lambda: bwd_products(g, a, b, c),
        "K4b_plain": lambda: bwd_products_reference(g, a, b, c),
        "K4b_bf16": lambda: bwd_products(g, a, b, c, bf16),
        "K4b_bf16_plain": lambda: bwd_products_reference(g, a, b, c, bf16),
    })
    for key, out_bytes, backward in (("K4a", 4, False), ("K4a_bf16", 2, False),
                                     ("K4b", 4, True), ("K4b_bf16", 2, True)):
        t[f"{key}_bound"], t[f"{key}_bound_by"] = ew_bound(a.numel(),
                                                           out_bytes, backward)
        log(f"[{key[:3]} time] wn18rr half (E {a.shape[0]}, d {a.shape[1]}, "
            f"{'bf16' if out_bytes == 2 else 'float32'} out): kernel "
            f"{t[key]:.4f} ms, plain {t[key + '_plain']:.4f} ms, bound "
            f"{t[key + '_bound']:.4f} ms ({t[key + '_bound_by']}), "
            f"{t[key + '_bound'] / t[key]:.1%} of bound; no one-call library "
            "equivalent")
    timings["ew_wn18rr"] = t
    log_profile("K4a at the WN18RR half shape", lambda: compose_msg(a, b, c),
                steps=5)
    log_profile("K4b at the WN18RR half shape",
                lambda: bwd_products(g, a, b, c), steps=5)
    del a, b, c, g, ew_cases

    # K3 at the stacked WN18RR shape on real operands.  "without padding"
    # runs it on the edge list without the 410 zero-norm padding edges of
    # rows N-1 and 2N-1 (same rows, same result); the yardstick is
    # index_add_ of the precomposed (2 E_pad, d) messages into the 2N rows,
    # as K7's is (no one PyTorch call composes and sums)
    k3 = k3_args["wn18rr_stacked_real"]
    x, src_, nm, rel_all, rel_, et, dst_, ip_, n_rows2 = k3
    keep = torch.cat([torch.arange(graph.inb.e_real),
                      graph.e_pad + torch.arange(graph.outb.e_real)]).to(device)
    dst_cut = dst_[keep].contiguous()
    ip_cut = torch.zeros_like(ip_)
    ip_cut[1:] = torch.cumsum(torch.bincount(dst_cut.long(),
                                             minlength=n_rows2), 0)
    k3_cut = (x, src_[keep].contiguous(), nm[keep].contiguous(), rel_all,
              rel_[keep].contiguous(), et[keep].contiguous(), dst_cut, ip_cut,
              n_rows2)
    if not torch.equal(fused_compose(*k3_cut), fused_compose(*k3)):
        raise AssertionError("K3 without the padding edges changed the sums")
    msg_pre = ((x[src_.long()] * nm[:, None]) * rel_all[rel_.long()]) * et
    lib_out = torch.zeros(n_rows2, d_in, device=device)
    dst_long = dst_.long()
    t = time_in_turns({
        "K3": lambda: fused_compose(*k3),
        "K3_plain": lambda: fused_compose_reference(*k3),
        "K3_yardstick": lambda: lib_out.index_add_(0, dst_long, msg_pre),
        "K3_without_padding": lambda: fused_compose(*k3_cut),
    })
    t["K3_bound"], t["K3_bound_by"] = k3_bound(
        ds.num_entity, n_rel_rows, et.shape[0], n_rows2, d_in)
    timings["k3_wn18rr_stacked"] = t
    log(f"[K3 time] wn18rr stacked (E {et.shape[0]}, rows {n_rows2}, d "
        f"{d_in}, {n_rel_rows} relation rows): kernel {t['K3']:.4f} ms, plain "
        f"{t['K3_plain']:.4f} ms, yardstick (index_add_ of the precomposed "
        f"messages) {t['K3_yardstick']:.4f} ms, bound {t['K3_bound']:.4f} ms "
        f"({t['K3_bound_by']}), {t['K3_bound'] / t['K3']:.1%} of bound; "
        f"without the {et.shape[0] - keep.shape[0]} padding edges "
        f"{t['K3_without_padding']:.4f} ms")
    log_profile("K3 at the stacked WN18RR shape", lambda: fused_compose(*k3),
                steps=5)
    del k3, k3_cut, k3_args, msg_pre, lib_out, x, et
    torch.cuda.empty_cache()

    # 5. training ---------------------------------------------------------------
    graph = graph.to(device)
    banks = make_banks(ds, device)
    steps_per_epoch = -(-banks["train"].n_queries // cfg0.batch_size)
    train = {}
    for impl in ("fused", "auto"):
        cfg = dataset_preset("WN18RR", seed=args.seed, loss_impl=impl)
        model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                            e_pad=graph.e_pad,
                            generator=torch.Generator().manual_seed(args.seed)
                            ).to(device)
        trainer = Trainer(cfg, model, graph, banks)
        fused = int(impl == "fused")
        train[impl] = timed_steps(
            trainer, launches, (4, fused, fused, 0, 0, 0, 0, 0, 0),
            f"loss_impl={impl} ({trainer.loss_impl})", args.seed)
        if fused:
            fused_trainer = trainer

    # one kernel step against the same step through the plain versions, from
    # the warm fused state, with one dropout mask
    bank = banks["train"]
    idx = torch.randperm(bank.n_queries, generator=gen)[:cfg0.batch_size]
    same_step(fused_trainer,
              fused_trainer.batch(idx.to(device),
                                  torch.ones(cfg0.batch_size, device=device)),
              args.seed + 7, launches, (4, 1, 1, 0, 0, 0, 0, 0, 0), "mgcn",
              degenerate=DEGENERATE)
    del fused_trainer, trainer, model

    # one epoch through the CLI entry point (the training main path)
    exp_dir = os.path.join(work.name, "experiments")
    run_dir = os.path.join(exp_dir, "SYN")
    argv = ["--dataset", "SYN", "--data_dir", corpus_root, "--experiments_dir",
            exp_dir, "--do_train", "--loss_impl", "fused", "--max_epoch", "1",
            "--eval_every", "1", "--seed", str(args.seed)]
    for flag in ("learning_rate", "gcn_drop", "feat_drop", "hidden_drop"):
        argv += [f"--{flag}", str(getattr(cfg0, flag))]   # the WN18RR preset's
    train_launches, ep = cli_epoch(
        argv, run_dir, launches,
        (4 * steps_per_epoch + 2, steps_per_epoch, steps_per_epoch, 0, 0, 0, 0,
         0, 0),
        f"cli --do_train --loss_impl fused --max_epoch 1 ({steps_per_epoch} "
        "steps)")
    train["fused"]["cli_epoch_s"] = ep["sec"]

    # 6. serving ----------------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    cfg = Config.from_json(os.path.join(run_dir, "params.json"))
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=graph.e_pad)
    state_dict, best = load_checkpoint(run_dir, cfg)
    model.load_state_dict(state_dict)
    model = model.to(device).eval()
    log(f"[serve] model {cfg.model}+{cfg.decoder} from the trained last.ckpt "
        f"(best Val MRR {best}): d_in {cfg.gcn_in_dim}, d_out "
        f"{cfg.gcn_out_dim}, {cfg.num_filter} filters "
        f"{cfg.kernel_size}x{cfg.kernel_size}, k_w x k_h {cfg.k_w}x{cfg.k_h}, "
        f"{cfg.compute_dtype}; "
        f"{sum(p.numel() for p in model.parameters())} parameters")

    id2ent = {i: e for e, i in ds.entity2id.items()}
    id2rel = {i: r for r, i in ds.relation2id.items()}
    test = ds.test_triples[:512]
    qfile = os.path.join(work.name, "queries.txt")
    with open(qfile, "w") as f:
        f.write("".join(f"{id2ent[s]}\t{id2rel[r]}\n" for s, r, _ in test))

    launches.zero()                                    # the serving path starts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = Predictor(cfg, model, graph, ds.entity2id, ds.relation2id)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    if segment_sum.launches != 2:
        raise AssertionError(f"encode launched K1 {segment_sum.launches} "
                             "times, want 2 (one per direction half)")
    t0 = time.perf_counter()
    lines = serve_file(pred, qfile, k=10, batch_size=128)
    serve_ms = (time.perf_counter() - t0) * 1e3
    stream_in = [f"{id2ent[int(s)]} {id2rel[int(r)]}" for s, r, _ in test[:2]]
    stream_in.append(f"{id2ent[int(test[2, 2])]} {id2rel[int(test[2, 1])]} head")
    stream = list(serve_stream(pred, stream_in, k=10))
    t0 = time.perf_counter()
    metrics = evaluate(cfg, model, graph, banks, "test", mark="Test")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    serve_launches = launches.read()                   # the serving path ends
    peak = torch.cuda.max_memory_allocated()

    records = [json.loads(x) for x in lines] + [json.loads(x) for x in stream]
    if len(lines) != 512 or len(stream) != 3:
        raise AssertionError(f"served {len(lines)} file + {len(stream)} "
                             "stream answers, want 512 + 3")
    for rec in records:
        if "topk" not in rec or len(rec["topk"]) != 10 or not all(
                math.isfinite(t["score"]) and t["entity"] in ds.entity2id
                for t in rec["topk"]):
            raise AssertionError(f"bad answer: {rec}")
    if not (serve_launches == (4, 0, 0, 0, 0, 0, 0, 0, 0)
            and 1.0 <= metrics["mr"] <= ds.num_entity
            and 0.0 < metrics["mrr"] <= 1.0
            and all(0.0 <= metrics[k] <= 1.0 for k in metrics if "hits" in k)):
        raise AssertionError(f"eval: launches {serve_launches}, metrics {metrics}")
    log(f"[serve] first calls: encode {encode_ms:.2f} ms (K1 launches 2); "
        f"serve_file 512 queries in 4 batches: {serve_ms / 4:.2f} ms/batch; "
        f"serve_stream 3 lines; eval {2 * len(ds.test_triples)} queries "
        f"{eval_s:.3f} s {metrics}; launches on the path "
        f"{Launches.show(serve_launches)}; peak memory {peak} B")

    # the same encode through the plain segment-sum on the card
    q = torch.as_tensor(test[:128], device=device).long()
    with torch.no_grad():
        ref_ent, ref_rel = model.encode(graph, kernels=PLAIN)
        torch.testing.assert_close(pred.all_ent, ref_ent, rtol=TOL, atol=TOL)
        torch.testing.assert_close(pred.all_rel, ref_rel, rtol=TOL, atol=TOL)
        got = torch.topk(model.decode(pred.all_ent, pred.all_rel, q[:, 0],
                                      q[:, 1]), 10)
        want = torch.topk(model.decode(ref_ent, ref_rel, q[:, 0], q[:, 1]), 10)
        assert_topk_match(got.values, got.indices, want.values, want.indices,
                          tol=1e-4)
    enc_err = float((pred.all_ent - ref_ent).abs().max())
    log(f"[serve] kernel encode vs plain encode: all_ent max_abs_err "
        f"{enc_err:.3g} (tol {TOL}); top-10 of 128 queries agree")

    # warm serving (the one-time CUDA / cuBLAS set-up is behind us)
    with torch.no_grad():
        encode = lambda: model.encode(graph)
        top_k = lambda: torch.topk(model.decode(pred.all_ent, pred.all_rel,
                                                q[:, 0], q[:, 1]), 10)
        dev = time_in_turns({"encode": encode, "top_k": top_k}, n=10,
                            warmup=1, lead_cycles=10_000_000)
        enc_host, topk_host = host_ms(encode, 5), host_ms(top_k, 10)
        serve_warm = host_ms(lambda: serve_file(pred, qfile, k=10,
                                                batch_size=128), 3) / 4
        eval_warm = host_ms(lambda: evaluate(cfg, model, graph, banks, "test",
                                             mark="Test"), 3) / 1e3
        log(f"[serve] warm: encode {enc_host:.3f} ms host, "
            f"{dev['encode']:.3f} ms device; top-10 of a 128-query batch "
            f"{topk_host:.3f} ms host, {dev['top_k']:.3f} ms device; "
            f"serve_file {serve_warm:.3f} ms/batch; eval {eval_warm:.3f} s")
        log_profile("encode", encode)
        log_profile("top-10 batch", top_k)
    del pred, model, ref_ent, ref_rel
    torch.cuda.empty_cache()

    # 7. R-GCN training (BASELINE config 3) -------------------------------------
    t0 = time.perf_counter()
    fb_root = os.path.join(work.name, "fb")
    write_corpus(os.path.join(fb_root, "SYN3"), args.seed, FB15K237)
    ds3 = load_dataset("SYN3", fb_root)
    graph3 = build_graph(ds3.train_triples, ds3.num_entity,
                         ds3.num_relation).to(device)
    banks3 = make_banks(ds3, device)
    log(f"[data] FB15k-237-shaped corpus: {ds3.num_entity} entities, "
        f"{ds3.num_relation} relations, {ds3.num_edge} train edges per half "
        f"(E_pad {graph3.e_pad}, 2E+N = {graph3.num_messages}); "
        f"{time.perf_counter() - t0:.1f} s")
    model3 = build_model(cfg3, ds3.num_entity, ds3.num_relation, ds3.num_edge,
                         generator=torch.Generator().manual_seed(args.seed)
                         ).to(device)
    trainer3 = NegativeSamplingTrainer(cfg3, model3, graph3, banks3)
    log(f"[train] rgcn config: {cfg3.num_layers} layer, B {model3.nb} bases, "
        f"d_in {cfg3.gcn_in_dim}, d_out {cfg3.gcn_out_dim}, decoder "
        f"{cfg3.decoder}, {cfg3.train_mode} K {cfg3.num_negatives} "
        f"({cfg3.neg_loss}), batch {cfg3.batch_size}, lr {cfg3.learning_rate}, "
        f"gcn_drop {cfg3.gcn_drop}, {cfg3.compute_dtype}, moments "
        f"{cfg3.moment_dtype}; {sum(p.numel() for p in model3.parameters())} "
        "parameters")
    train["rgcn"] = timed_steps(trainer3, launches,
                                (2, 0, 0, 2, 2, 0, 0, 0, 0),
                                "rgcn + distmult, negative sampling",
                                args.seed)

    # one kernel step against the same step through the plain versions, from
    # the warm state, with the same negatives and dropout masks
    idx = torch.randperm(trainer3.n_train, generator=gen)[:cfg3.batch_size]
    same_step(trainer3,
              trainer3.batch(idx.to(device),
                             torch.ones(cfg3.batch_size, device=device)),
              args.seed + 7, launches, (2, 0, 0, 2, 2, 0, 0, 0, 0), "rgcn")
    est_epoch_s = trainer3.steps_per_epoch / train["rgcn"]["steps_per_s"]
    del trainer3, model3
    torch.cuda.empty_cache()

    # one epoch through the CLI entry point (the R-GCN training main path);
    # above CLI_EPOCH_LIMIT_S the corpus keeps its entities and relations
    # and has fewer train triples
    cli_root, ds_cli = fb_root, ds3
    if est_epoch_s > CLI_EPOCH_LIMIT_S:
        n_cut = int(FB15K237[2] * CLI_EPOCH_LIMIT_S / est_epoch_s)
        cli_root = os.path.join(work.name, "fb_cut")
        write_corpus(os.path.join(cli_root, "SYN3"), args.seed,
                     (*FB15K237[:2], n_cut, *FB15K237[3:]))
        ds_cli = load_dataset("SYN3", cli_root)
        log(f"[train] rgcn CLI epoch cut: {est_epoch_s:.1f} s estimated at "
            f"full size > {CLI_EPOCH_LIMIT_S} s; {n_cut} train triples")
    exp3 = os.path.join(work.name, "experiments_rgcn")
    run3 = os.path.join(exp3, "SYN3")
    # the dataset is not named FB15k-237, so the parser's defaults apply
    # (eval_every 1) and the FB15k-237 preset's lr and dropout are passed
    argv3 = ["--dataset", "SYN3", "--data_dir", cli_root,
             "--experiments_dir", exp3, "--do_train", "--max_epoch", "1",
             "--eval_every", "1", "--seed", str(args.seed), "--model", "rgcn",
             "--decoder", "distmult", "--num_bases", "30", "--train_mode",
             "negative_sampling", "--compute_dtype", "float32",
             "--moment_dtype", "float32", "--learning_rate",
             str(cfg3.learning_rate), "--gcn_drop", str(cfg3.gcn_drop)]
    cli_steps = -(-2 * ds_cli.num_edge // cfg3.batch_size)
    rgcn_train_launches, ep = cli_epoch(
        argv3, run3, launches,
        (2 * cli_steps, 0, 0, 2 * cli_steps + 2, 2 * cli_steps, 0, 0, 0, 0),
        f"cli --model rgcn --decoder distmult --num_bases 30 --train_mode "
        f"negative_sampling --max_epoch 1 ({cli_steps} steps, "
        f"{ds_cli.num_edge} train triples)")
    train["rgcn"]["cli_epoch_s"] = ep["sec"]

    # 8. R-GCN serving: the checkpoint through the CLI ----------------------------
    id2ent = {i: e for e, i in ds_cli.entity2id.items()}
    id2rel = {i: r for r, i in ds_cli.relation2id.items()}
    test3 = ds_cli.test_triples[:512]
    qfile3 = os.path.join(work.name, "queries_rgcn.txt")
    with open(qfile3, "w") as f:
        f.write("".join(f"{id2ent[s_]}\t{id2rel[r_]}\n" for s_, r_, _ in test3))
    serve_base = ["--dataset", "SYN3", "--data_dir", cli_root,
                  "--restore_dir", run3, "--experiments_dir",
                  os.path.join(work.name, "serve_rgcn")]
    rgcn_serve_launches, metrics3 = cli_serve(
        serve_base, qfile3, len(test3), ds_cli.entity2id, launches,
        (0, 0, 0, 4, 0, 0, 0, 0, 0), "rgcn")
    if cli_root != fb_root:
        graph3 = build_graph(ds_cli.train_triples, ds_cli.num_entity,
                             ds_cli.num_relation).to(device)
        banks3 = make_banks(ds_cli, device)
    served_encode(run3, ds_cli, graph3, banks3, test3[:128], metrics3, "rgcn")
    del graph3, banks3
    torch.cuda.empty_cache()

    # 9. RGAT training (bench.py's rgat_pallas) ---------------------------------
    cfg_a = dataset_preset("WN18RR", model="rgat", decoder="distmult",
                           num_heads=4, seed=args.seed)
    model_a = build_model(cfg_a, ds.num_entity, ds.num_relation, ds.num_edge,
                          generator=torch.Generator().manual_seed(args.seed)
                          ).to(device)
    trainer_a = Trainer(cfg_a, model_a, graph, banks)
    log(f"[train] rgat config: {cfg_a.num_layers} layer, {cfg_a.num_heads} "
        f"heads of {cfg_a.gcn_out_dim // cfg_a.num_heads}, d_in "
        f"{cfg_a.gcn_in_dim}, d_out {cfg_a.gcn_out_dim}, decoder "
        f"{cfg_a.decoder}, {cfg_a.train_mode} (loss_impl {cfg_a.loss_impl} = "
        f"{trainer_a.loss_impl}, label smoothing {cfg_a.lbl_smooth}), batch "
        f"{cfg_a.batch_size}, lr {cfg_a.learning_rate}, gcn_drop "
        f"{cfg_a.gcn_drop}, {cfg_a.compute_dtype}, moments "
        f"{cfg_a.moment_dtype}; {sum(p.numel() for p in model_a.parameters())}"
        " parameters")
    # per half and layer: K5 once, K1 on expd (E, 4) and on msg (E, 200);
    # backward K1 for edge_compose's d_h and both gather_rows_sorted
    train["rgat"] = timed_steps(trainer_a, launches,
                                (10, 0, 0, 0, 0, 2, 0, 0, 0),
                                "rgat + distmult, 1-vs-all", args.seed)

    # one kernel step against the same step through the plain versions, from
    # the warm state (non-zero attention bias), with one dropout mask
    idx = torch.randperm(bank.n_queries, generator=gen)[:cfg_a.batch_size]
    same_step(trainer_a,
              trainer_a.batch(idx.to(device),
                              torch.ones(cfg_a.batch_size, device=device)),
              args.seed + 7, launches, (10, 0, 0, 0, 0, 2, 0, 0, 0), "rgat",
              cancelling=RGAT_DEGENERATE)
    del trainer_a, model_a
    torch.cuda.empty_cache()

    # one epoch through the CLI entry point (the RGAT training main path):
    # every step, then the validation encode
    exp_a = os.path.join(work.name, "experiments_rgat")
    run_a = os.path.join(exp_a, "SYN")
    argv_a = ["--dataset", "SYN", "--data_dir", corpus_root,
              "--experiments_dir", exp_a, "--do_train", "--max_epoch", "1",
              "--eval_every", "1", "--seed", str(args.seed), "--model", "rgat",
              "--decoder", "distmult", "--num_heads", str(cfg_a.num_heads),
              "--learning_rate", str(cfg_a.learning_rate), "--gcn_drop",
              str(cfg_a.gcn_drop)]
    rgat_train_launches, ep = cli_epoch(
        argv_a, run_a, launches,
        (10 * steps_per_epoch + 4, 0, 0, 0, 0, 2 * steps_per_epoch + 2, 0, 0,
         0),
        f"cli --model rgat --decoder distmult --num_heads {cfg_a.num_heads} "
        f"--max_epoch 1 ({steps_per_epoch} steps)")
    train["rgat"]["cli_epoch_s"] = ep["sec"]

    # 10. RGAT serving: the checkpoint through the CLI (one encode for
    # --do_test, one for --do_predict) ---------------------------------------------
    serve_a = ["--dataset", "SYN", "--data_dir", corpus_root, "--restore_dir",
               run_a, "--experiments_dir", os.path.join(work.name, "serve_rgat")]
    rgat_serve_launches, metrics_a = cli_serve(
        serve_a, qfile, len(test), ds.entity2id, launches,
        (8, 0, 0, 0, 0, 4, 0, 0, 0), "rgat")
    serve_rgat = served_encode(run_a, ds, graph, banks, test[:128], metrics_a,
                               "rgat")

    # 11. MGCN's aggregation schedules (the WN18RR preset, 1-vs-all with
    # loss_impl auto; ew_impl is a Config field, reached through Trainer) --
    paths = {}
    for name, field, per_step in (
            ("ew_pallas", dict(ew_impl="pallas"), (4, 0, 0, 0, 0, 0, 0, 2, 2)),
            ("stacked", dict(spmm_mode="stacked"), (1, 0, 0, 0, 0, 0, 1, 0, 0)),
            ("stacked_xla", dict(spmm_mode="stacked_xla"),
             (2, 0, 0, 0, 0, 0, 0, 0, 0))):
        cfg_s = dataset_preset("WN18RR", seed=args.seed, **field)
        model_s = build_model(cfg_s, ds.num_entity, ds.num_relation,
                              ds.num_edge, e_pad=graph.e_pad,
                              generator=torch.Generator().manual_seed(
                                  args.seed)).to(device)
        trainer_s = Trainer(cfg_s, model_s, graph, banks)
        train[f"mgcn_{name}"] = timed_steps(
            trainer_s, launches, per_step,
            f"mgcn {name} (loss_impl {trainer_s.loss_impl})", args.seed)
        paths[f"mgcn_{name}_steps"] = tuple(TIMED_STEPS * c for c in per_step)
        idx = torch.randperm(bank.n_queries, generator=gen)[:cfg_s.batch_size]
        same_step(trainer_s,
                  trainer_s.batch(idx.to(device),
                                  torch.ones(cfg_s.batch_size, device=device)),
                  args.seed + 7, launches, per_step, f"mgcn {name}",
                  degenerate=DEGENERATE)
        del trainer_s, model_s
        torch.cuda.empty_cache()

    # one epoch of the stacked schedule through the CLI, then its checkpoint
    # served through the CLI with the same flags
    exp_s = os.path.join(work.name, "experiments_stacked")
    run_s = os.path.join(exp_s, "SYN")
    flags_s = ["--use_pallas", "--spmm_mode", "stacked"]
    argv_s = ["--dataset", "SYN", "--data_dir", corpus_root,
              "--experiments_dir", exp_s, "--do_train", "--max_epoch", "1",
              "--eval_every", "1", "--seed", str(args.seed)] + flags_s
    for flag in ("learning_rate", "gcn_drop", "feat_drop", "hidden_drop"):
        argv_s += [f"--{flag}", str(getattr(cfg0, flag))]
    paths["mgcn_stacked_train"], ep = cli_epoch(
        argv_s, run_s, launches,
        (steps_per_epoch, 0, 0, 0, 0, 0, steps_per_epoch + 1, 0, 0),
        f"cli {' '.join(flags_s)} --max_epoch 1 ({steps_per_epoch} steps)")
    train["mgcn_stacked"]["cli_epoch_s"] = ep["sec"]
    serve_s = ["--dataset", "SYN", "--data_dir", corpus_root, "--restore_dir",
               run_s, "--experiments_dir",
               os.path.join(work.name, "serve_stacked")] + flags_s
    paths["mgcn_stacked_serve"], metrics_s = cli_serve(
        serve_s, qfile, len(test), ds.entity2id, launches,
        (0, 0, 0, 0, 0, 0, 2, 0, 0), "mgcn stacked")
    serve_stacked = served_encode(run_s, ds, graph, banks, test[:128],
                                  metrics_s, "mgcn stacked")
    work.cleanup()

    paths.update({"mgcn_train": train_launches, "mgcn_serve": serve_launches,
                  "rgcn_train": rgcn_train_launches,
                  "rgcn_serve": rgcn_serve_launches,
                  "rgat_train": rgat_train_launches,
                  "rgat_serve": rgat_serve_launches})
    by_path = lambda i: {k: v[i] for k, v in paths.items()}
    entries = [k1_entry(errs, timings, by_path(0))]
    k2_main = timings["k2_main"]
    for i, (key, fn_name, line) in enumerate((
            ("K2a", "fused_bce_loss", 125), ("K2b", "fused_bce_grads", 145))):
        entries.append({
            "name": f"{fn_name} ({key})", "route": "cuda",
            "source": "kgc_gcn_torch/csrc/fused_score_bce.cu",
            "replaces": f"kgc_gcn_tpu/ops/fused_loss.py:{line}",
            "launches": sum(by_path(1 + i).values()),
            "max_abs_err": max(k2_errs[key].values()),
            "ms": k2_main[key], "plain_ms": k2_main[f"{key}_plain"],
            "bound_ms": k2_main[f"{key}_bound"],
            "bound_by": k2_main[f"{key}_bound_by"],
            "library_ms": None,
            "yardstick": "addmm(bias, h, ent.T)",
            "yardstick_ms": k2_main["addmm"],
            "launches_by_path": by_path(1 + i),
            "cases": {"edge": {k: v for k, v in timings["k2_edge"].items()
                               if k.startswith(key) or k == "addmm"},
                      "max_abs_err": k2_errs[key]},
        })
    t3 = timings["basis_config3"]
    for i, (key, fn_name, line, yard) in enumerate((
            ("K7", "basis_sum", 918, "index_add_ of the pre-built expansion"),
            ("K8", "basis_bwd", 1181, "two einsums on a pre-gathered sel"))):
        entries.append({
            "name": f"{fn_name} ({key})", "route": "cuda",
            "source": "kgc_gcn_torch/csrc/basis_rgcn.cu",
            "replaces": f"kgc_gcn_tpu/ops/spmm_pallas.py:{line}",
            "launches": sum(by_path(3 + i).values()),
            "max_abs_err": max(basis_errs[key].values()),
            "ms": t3[key], "plain_ms": t3[f"{key}_plain"],
            "bound_ms": t3[f"{key}_bound"], "bound_by": t3[f"{key}_bound_by"],
            "library_ms": None, "yardstick": yard,
            "yardstick_ms": t3[f"{key}_yardstick"],
            "ms_without_padding": t3[f"{key}_without_padding"],
            "launches_by_path": by_path(3 + i),
            "cases": {"max_abs_err": basis_errs[key]},
        })
    t5 = timings["k5_wn18rr_h4"]
    entries.append({
        "name": "segment_max (K5)", "route": "cuda",
        "source": "kgc_gcn_torch/csrc/segment_max.cu",
        "replaces": "kgc_gcn_tpu/ops/spmm_pallas.py:801",
        "launches": sum(by_path(5).values()),
        "max_abs_err": max(max_errs.values()),
        "ms": t5["ms"], "plain_ms": t5["plain_ms"],
        "bound_ms": t5["bound_ms"], "bound_by": t5["bound_by"],
        "library_ms": t5["library_ms"], "library": t5["library"],
        "ms_without_padding": t5["ms_without_padding"],
        "launches_by_path": by_path(5),
        "cases": {"max_abs_err": max_errs},
    })
    t3k = timings["k3_wn18rr_stacked"]
    entries.append({
        "name": "fused_compose (K3)", "route": "cuda",
        "source": "kgc_gcn_torch/csrc/fused_compose.cu",
        "replaces": "kgc_gcn_tpu/ops/spmm_pallas.py:267",
        "launches": sum(by_path(6).values()),
        "max_abs_err": max(k3_errs.values()),
        "ms": t3k["K3"], "plain_ms": t3k["K3_plain"],
        "bound_ms": t3k["K3_bound"], "bound_by": t3k["K3_bound_by"],
        "library_ms": None,
        "yardstick": "index_add_ of the precomposed messages",
        "yardstick_ms": t3k["K3_yardstick"],
        "ms_without_padding": t3k["K3_without_padding"],
        "launches_by_path": by_path(6),
        "cases": {"max_abs_err": k3_errs},
    })
    tew = timings["ew_wn18rr"]
    for i, (key, fn_name, line) in enumerate((("K4a", "compose_msg", 37),
                                              ("K4b", "bwd_products", 71))):
        entries.append({
            "name": f"{fn_name} ({key})", "route": "cuda",
            "source": "kgc_gcn_torch/csrc/elementwise.cu",
            "replaces": f"kgc_gcn_tpu/ops/elementwise_pallas.py:{line}",
            "launches": sum(by_path(7 + i).values()),
            "max_abs_err": max(ew_errs[key].values()),
            "ms": tew[key], "plain_ms": tew[f"{key}_plain"],
            "bound_ms": tew[f"{key}_bound"],
            "bound_by": tew[f"{key}_bound_by"],
            "library_ms": None, "yardstick": "none",
            "bf16_out": {k: tew[f"{key}_bf16{k}"] for k in (
                "", "_plain", "_bound")},
            "launches_by_path": by_path(7 + i),
            "cases": {"max_abs_err": ew_errs[key]},
        })
    log(json.dumps({"training": train, "serve_rgat": serve_rgat,
                    "serve_mgcn_stacked": serve_stacked, "few_sum": {
                        k: v for k, v in timings.items()
                        if k.startswith("few_sum")},
                    "basis_matmul_ms": t3["basis_matmul"]}))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def k1_entry(errs: dict, timings: dict, launches_by_path: dict) -> dict:
    """K1's entry of the kernels line: the WN18RR dst-order case's times,
    every case's times and errors, and the launches of the paths driven."""
    main_t = timings["wn18rr_f32"]
    return {
        "name": "segment_sum (K1)", "route": "cuda",
        "source": "kgc_gcn_torch/csrc/segment_sum.cu",
        "replaces": "kgc_gcn_tpu/ops/spmm_pallas.py:126",
        "launches": sum(launches_by_path.values()),
        "max_abs_err": max(errs.values()),
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "launches_by_path": launches_by_path,
        "cases": {name: {**timings.get(name, {}), "max_abs_err": err}
                  for name, err in errs.items()},
    }


class _Capture(logging.Handler):
    """Keeps the messages of the root logger's records (the CLI logs its
    test metrics)."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


if __name__ == "__main__":
    sys.exit(main())
