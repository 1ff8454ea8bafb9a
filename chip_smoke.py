#!/usr/bin/env python3
"""Smoke run of kgc_gcn_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and the script exits non-zero:
  1. device: require a CUDA card, print its name and power limit;
  2. build: compile the port's CUDA kernels from kgc_gcn_torch/csrc;
  3. kernels: hold each kernel against its plain PyTorch version on the card
     at the shapes the training and serving paths give it, plus an edge case:
     K1 (segment-sum) in dst, src and rel order, K2a / K2b (fused score +
     BCE, forward and backward);
  4. timing: each kernel, its plain version and the one-call library
     equivalent or yardstick, with CUDA events, beside the least time the
     card needs;
  5. training: the reference model (MGCN + ConvE at full width, WN18RR
     preset and dropout, random weights from --seed) on a WN18RR-shaped
     synthetic corpus: timed steps with loss_impl fused and auto (steps/s,
     edges/s, launches per step, profile, peak memory), one kernel step
     against the same step through the plain versions, then one training
     epoch through the CLI entry point, which writes last.ckpt;
  6. serving: that checkpoint served: encode once, 512 file queries and 3
     stream queries, the filtered metrics on the test split, and the encode
     held against the same encode through the plain segment-sum.
K1 checks use dyadic messages, whose float32 sums are exact in any order,
so kernel and plain version must agree to the bit.
The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.  Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import copy
import json
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
TIMED_STEPS = 50
# WN18RR's counts (scripts/make_synth_corpus.py): entities, relations,
# train / valid / test triples; FB15k-237's for the bf16 kernel case
WN18RR = (40943, 11, 86835, 3000, 3000)
FB15K237 = (14541, 237, 272115)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ helpers

def write_corpus(root: str, seed: int) -> None:
    """WN18RR-shaped random triples as TSV; every entity appears in train."""
    n_ent, n_rel, n_train, n_valid, n_test = WN18RR
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


def close_rel(got, want, rtol, atol_rel, what) -> float:
    """assert_close with the absolute part relative to max |want|; returns
    the max abs error."""
    atol = atol_rel * float(want.abs().max()) + 1e-30
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=what)
    return float((got - want).abs().max())


# ------------------------------------------------------------------- phases

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # 1. device ---------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from kgc_gcn_torch import cli
    from kgc_gcn_torch.config import Config, dataset_preset
    from kgc_gcn_torch.convert import jax_leaf_names
    from kgc_gcn_torch.data.batching import make_banks
    from kgc_gcn_torch.data.dataset import load_dataset
    from kgc_gcn_torch.data.graph import build_graph
    from kgc_gcn_torch.models import build_model
    from kgc_gcn_torch.ops.fused_loss import (
        dense_grads, dense_grads_reference, dense_loss, dense_loss_reference)
    from kgc_gcn_torch.ops.segment_sum import segment_sum, segment_sum_reference
    from kgc_gcn_torch.serve import Predictor, serve_file, serve_stream
    from kgc_gcn_torch.train import optim
    from kgc_gcn_torch.train.checkpoint import load_checkpoint
    from kgc_gcn_torch.train.loop import Trainer, evaluate
    from kgc_gcn_torch.utils.cuda_build import load_kernels
    from kgc_gcn_torch.utils.device import resolve_device

    device = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; count {torch.cuda.device_count()}")
    log(smi)
    counters = (segment_sum, dense_loss, dense_grads)

    def zero_counts():
        for f in counters:
            f.launches = 0

    def counts():
        return tuple(f.launches for f in counters)

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
    write_corpus(os.path.join(corpus_root, "SYN"), args.seed)
    ds = load_dataset("SYN", corpus_root)
    graph = build_graph(ds.train_triples, ds.num_entity, ds.num_relation)
    n_fb, r_fb, e_fb = FB15K237
    rng = np.random.default_rng(args.seed + 1)
    fb_tri = np.stack([rng.integers(n_fb, size=e_fb), rng.integers(r_fb, size=e_fb),
                       rng.integers(n_fb, size=e_fb)], axis=1)
    fb_graph = build_graph(fb_tri, n_fb, r_fb)
    log(f"[data] {ds.num_entity} entities, {ds.num_relation} relations, "
        f"{ds.num_edge} train edges (E_pad {graph.e_pad}), "
        f"{ds.num_train_queries} train queries; FB15k-237-shaped graph E_pad "
        f"{fb_graph.e_pad}; {time.perf_counter() - t0:.1f} s")

    d_in = dataset_preset("WN18RR").gcn_in_dim
    hub = torch.randint(0, 4, (1001,), generator=gen)
    hub[[0, 500, 1000]] = 0
    hub[123] = 5000
    cases = {
        "wn18rr_f32": half_case(graph.inb, ds.num_entity, d_in, torch.float32, gen),
        "fb15k237_bf16": half_case(fb_graph.inb, n_fb, d_in, torch.bfloat16, gen),
        "edge_f32": csr_case(hub, 37, torch.float32, gen),
        "edge_bf16": csr_case(hub, 37, torch.bfloat16, gen),
        # the backward's uses: d_x over src-sorted edges, d_rel over
        # rel-sorted edges (the K1 branch of segment_sum_few)
        "wn18rr_src_f32": half_case(graph.inb, ds.num_entity, d_in,
                                    torch.float32, gen, "src"),
        "wn18rr_rel_f32": half_case(graph.outb, ds.num_entity, d_in,
                                    torch.float32, gen, "rel"),
        "fb15k237_src_bf16": half_case(fb_graph.inb, n_fb, d_in,
                                       torch.bfloat16, gen, "src"),
        "fb15k237_rel_bf16": half_case(fb_graph.outb, n_fb, d_in,
                                       torch.bfloat16, gen, "rel"),
    }
    errs = {}
    for name, (msg, dst, indptr, n_rows) in cases.items():
        got = segment_sum(msg, dst, indptr, n_rows)
        want = segment_sum_reference(msg, dst, indptr, n_rows)
        torch.cuda.synchronize()
        errs[name] = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL,
                                   msg=name)
        log(f"[K1 check] {name}: E={msg.shape[0]} D={msg.shape[1]} "
            f"rows={n_rows} max_abs_err={errs[name]:.3g} (tol {KERNEL_TOL})")

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

    # 4. timing -----------------------------------------------------------------
    # The graph pads each half with zero-norm edges, all in row N-1 of the
    # dst order (and in row 0 of the src order): one serial hub row.
    # "ms_without_padding" times the forward with those edges cut off
    # (indptr[-1] = e_real, same messages) to size that row's cost.
    timings = {}
    for name, e_real in (("wn18rr_f32", graph.inb.e_real),
                         ("fb15k237_bf16", fb_graph.inb.e_real),
                         ("wn18rr_src_f32", None), ("wn18rr_rel_f32", None),
                         ("fb15k237_src_bf16", None),
                         ("fb15k237_rel_bf16", None)):
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
        timings[name] = t
        pad = (f"; without the {msg.shape[0] - e_real} padding edges: "
               f"{t['ms_without_padding']:.4f} ms" if e_real is not None else "")
        log(f"[K1 time] {name}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, index_add_ {t['library_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}); "
            f"{t['bound_ms'] / t['ms']:.1%} of bound{pad}")

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

    # 5. training ---------------------------------------------------------------
    graph = graph.to(device)
    banks = make_banks(ds, device)
    n_msgs = graph.num_messages
    steps_per_epoch = -(-banks["train"].n_queries // cfg0.batch_size)
    train = {}
    model = None
    for impl in ("fused", "auto"):
        cfg = dataset_preset("WN18RR", seed=args.seed, loss_impl=impl)
        model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                            e_pad=graph.e_pad,
                            generator=torch.Generator().manual_seed(args.seed)
                            ).to(device)
        trainer = Trainer(cfg, model, graph, banks)
        host_rng = np.random.default_rng(args.seed)
        trainer.train_epoch(1, host_rng, max_steps=3)      # one-time set-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        loss = trainer.train_epoch(1, host_rng, max_steps=TIMED_STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        k1, k2a, k2b = counts()
        peak = torch.cuda.max_memory_allocated()
        want = (4 * TIMED_STEPS, TIMED_STEPS, TIMED_STEPS) if impl == "fused" \
            else (4 * TIMED_STEPS, 0, 0)
        if (k1, k2a, k2b) != want or not math.isfinite(loss):
            raise AssertionError(f"{impl}: launches (K1, K2a, K2b) "
                                 f"{(k1, k2a, k2b)}, want {want}; loss {loss}")
        sps = TIMED_STEPS / dt
        bank = banks["train"]
        idx = torch.arange(cfg.batch_size, device=device)
        batch = (bank.queries[idx], bank.label_idx[idx],
                 torch.ones(cfg.batch_size, device=device))
        lr = optim.epoch_lr(cfg, 1)
        prof = log_profile(f"one {impl} training step",
                           lambda: trainer.train_step(lr, *batch), steps=3)
        phases = phase_ms(trainer, batch, lr)
        log(f"[train] {impl} step phases (host ms, each ended by a sync): "
            + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
        prof["phases_ms"] = phases
        train[impl] = {"steps_per_s": sps, "edges_per_s": sps * n_msgs,
                       "peak_bytes": peak, "loss": loss, **prof,
                       "launches_per_step": {"K1": k1 / TIMED_STEPS,
                                             "K2a": k2a / TIMED_STEPS,
                                             "K2b": k2b / TIMED_STEPS}}
        log(f"[train] loss_impl={impl} ({trainer.loss_impl}): "
            f"{TIMED_STEPS} warm steps in {dt:.3f} s = {sps:.2f} steps/s, "
            f"{sps * n_msgs:.4g} edges/s (2E+N = {n_msgs}); mean loss "
            f"{loss:.6f}; launches per step K1 {k1 / TIMED_STEPS:g}, K2a "
            f"{k2a / TIMED_STEPS:g}, K2b {k2b / TIMED_STEPS:g}; peak memory "
            f"{peak} B; an epoch of {steps_per_epoch} steps ~ "
            f"{steps_per_epoch / sps:.1f} s")
        if impl == "fused":
            fused_model, fused_trainer = model, trainer

    # one kernel step against the same step through the plain versions, from
    # the warm fused state, with one dropout mask
    cfg = fused_trainer.cfg
    plain = Trainer(cfg, copy.deepcopy(fused_model), graph, banks, plain=True)
    plain.opt_state = optim.AdamState(
        fused_trainer.opt_state.count,
        [m.clone() for m in fused_trainer.opt_state.mu],
        [v.clone() for v in fused_trainer.opt_state.nu])
    bank = banks["train"]
    idx = torch.randperm(bank.n_queries, generator=gen)[:cfg.batch_size].to(device)
    batch = (bank.queries[idx], bank.label_idx[idx],
             torch.ones(cfg.batch_size, device=device))
    before = [p.detach().clone() for p in fused_trainer.params]
    result = {}
    for name, t in (("kernel", fused_trainer), ("plain", plain)):
        t.generator.manual_seed(args.seed + 7)
        zero_counts()
        loss = t.loss(*batch)
        grads = list(torch.autograd.grad(loss, t.params))
        optim.step(t.params, grads, t.opt_state, cfg, optim.epoch_lr(cfg, 1))
        result[name] = (loss.detach(), grads, counts())
    if result["kernel"][2] != (4, 1, 1) or result["plain"][2] != (0, 0, 0):
        raise AssertionError(f"same-step launches {result['kernel'][2]} / "
                             f"{result['plain'][2]}")
    torch.testing.assert_close(result["kernel"][0], result["plain"][0],
                               rtol=STEP_LOSS_RTOL, atol=0.0, msg="step loss")
    step_err = {"grad": 0.0, "update": 0.0}
    for i, name in enumerate(jax_leaf_names(cfg)[0]):
        gk, gp = result["kernel"][1][i], result["plain"][1][i]
        uk = fused_trainer.params[i].detach() - before[i]
        up = plain.params[i].detach() - before[i]
        if not (torch.isfinite(gk).all() and torch.isfinite(uk).all()):
            raise AssertionError(f"same step: non-finite {name}")
        if name in DEGENERATE:
            continue
        step_err["grad"] = max(step_err["grad"], close_rel(
            gk, gp, STEP_RTOL, STEP_ATOL, f"same step: grad {name}"))
        step_err["update"] = max(step_err["update"], close_rel(
            uk, up, STEP_RTOL, STEP_ATOL, f"same step: update {name}"))
    log(f"[train] kernel step vs plain step (warm Adam, count "
        f"{fused_trainer.opt_state.count}): loss {float(result['kernel'][0]):.8f}"
        f" vs {float(result['plain'][0]):.8f}; max abs err grads "
        f"{step_err['grad']:.3g}, updates {step_err['update']:.3g} (rtol "
        f"{STEP_RTOL}, atol {STEP_ATOL} x max; {', '.join(DEGENERATE)} "
        "checked finite only)")
    del plain, fused_model, fused_trainer, model, trainer

    # one epoch through the CLI entry point (the training main path)
    exp_dir = os.path.join(work.name, "experiments")
    argv = ["--dataset", "SYN", "--data_dir", corpus_root, "--experiments_dir",
            exp_dir, "--do_train", "--loss_impl", "fused", "--max_epoch", "1",
            "--eval_every", "1", "--seed", str(args.seed)]
    for flag in ("learning_rate", "gcn_drop", "feat_drop", "hidden_drop"):
        argv += [f"--{flag}", str(getattr(cfg0, flag))]   # the WN18RR preset's
    torch.cuda.synchronize()
    zero_counts()                                      # the training path starts
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        raise AssertionError("cli --do_train failed")
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    train_launches = counts()                          # the training path ends
    run_dir = os.path.join(exp_dir, "SYN")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    ep = recs[-1]
    if not (ep.get("epoch") == 1 and math.isfinite(ep["loss"])
            and os.path.exists(os.path.join(run_dir, "last.ckpt"))
            and 0.0 < ep["val"]["mrr"] <= 1.0):
        raise AssertionError(f"cli epoch: {recs}")
    k1, k2a, k2b = train_launches
    if not (k2a == k2b == steps_per_epoch
            and k1 == 4 * steps_per_epoch + 2):
        raise AssertionError(f"cli epoch launches {train_launches} for "
                             f"{steps_per_epoch} steps")
    log(f"[train] cli --do_train --loss_impl fused --max_epoch 1: "
        f"{steps_per_epoch} steps + validation in {cli_s:.2f} s (epoch "
        f"{ep['sec']} s); loss {ep['loss']}; Val {ep['val']}; launches K1 "
        f"{k1}, K2a {k2a}, K2b {k2b}; last.ckpt written")

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

    zero_counts()                                      # the serving path starts
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
    serve_launches = counts()                          # the serving path ends
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
    if not (serve_launches == (4, 0, 0) and 1.0 <= metrics["mr"] <= ds.num_entity
            and 0.0 < metrics["mrr"] <= 1.0
            and all(0.0 <= metrics[k] <= 1.0 for k in metrics if "hits" in k)):
        raise AssertionError(f"eval: launches {serve_launches}, metrics {metrics}")
    log(f"[serve] first calls: encode {encode_ms:.2f} ms (K1 launches 2); "
        f"serve_file 512 queries in 4 batches: {serve_ms / 4:.2f} ms/batch; "
        f"serve_stream 3 lines; eval {2 * len(ds.test_triples)} queries "
        f"{eval_s:.3f} s {metrics}; launches on the path (K1, K2a, K2b) "
        f"{serve_launches}; peak memory {peak} B")

    # the same encode through the plain segment-sum on the card
    q = torch.as_tensor(test[:128], device=device).long()
    with torch.no_grad():
        ref_ent, ref_rel = model.encode(graph, seg_sum=segment_sum_reference)
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
    work.cleanup()

    main_t = timings["wn18rr_f32"]
    k1_err = max(errs.values())
    entries = [{
        "name": "segment_sum", "route": "cuda",
        "source": "kgc_gcn_torch/csrc/segment_sum.cu",
        "replaces": "kgc_gcn_tpu/ops/spmm_pallas.py:126",
        "launches": train_launches[0] + serve_launches[0],
        "max_abs_err": k1_err,
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "launches_by_path": {"train": train_launches[0],
                             "serve": serve_launches[0]},
        "cases": {name: {**timings.get(name, {}), "max_abs_err": err}
                  for name, err in errs.items()},
    }]
    k2_main = timings["k2_main"]
    for i, (key, fn_name, line) in enumerate((
            ("K2a", "fused_bce_loss", 125), ("K2b", "fused_bce_grads", 145))):
        entries.append({
            "name": f"{fn_name} ({key})", "route": "cuda",
            "source": "kgc_gcn_torch/csrc/fused_score_bce.cu",
            "replaces": f"kgc_gcn_tpu/ops/fused_loss.py:{line}",
            "launches": train_launches[1 + i] + serve_launches[1 + i],
            "max_abs_err": max(k2_errs[key].values()),
            "ms": k2_main[key], "plain_ms": k2_main[f"{key}_plain"],
            "bound_ms": k2_main[f"{key}_bound"],
            "bound_by": k2_main[f"{key}_bound_by"],
            "library_ms": None,
            "yardstick_addmm_ms": k2_main["addmm"],
            "launches_by_path": {"train": train_launches[1 + i],
                                 "serve": serve_launches[1 + i]},
            "cases": {"edge": {k: v for k, v in timings["k2_edge"].items()
                               if k.startswith(key) or k == "addmm"},
                      "max_abs_err": k2_errs[key]},
        })
    log(json.dumps({"training": train, "few_sum": {
        k: v for k, v in timings.items() if k.startswith("few_sum")}}))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
