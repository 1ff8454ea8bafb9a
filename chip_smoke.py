#!/usr/bin/env python3
"""Smoke run of kgc_gcn_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--kernels-only | --mesh-only |
                           --entity-only | --rest-only | --remat-only]

Phases, in order; any failure raises and the script exits non-zero:
  1. device: require a CUDA card, print its name and power limit;
  2. build: compile the port's CUDA kernels from kgc_gcn_torch/csrc;
  3. kernels: hold each kernel against its plain PyTorch version on the card
     at the shapes the training and serving paths give it, plus an edge case:
     K1 (segment-sum) in dst, src and rel order, at RGAT's widths 4 and 200,
     on a power-law graph at FB15k-237's counts and in that graph's rel
     order, and twice on normal values (bit-identical calls), K2a / K2b
     (fused score + BCE, forward and backward, at the WN18RR and FB15k-237
     shapes and their edges: B above one row chunk, N below one tile and one
     past a tile multiple, d 300, d 1, d 203 and d 496, h and ent not
     16-byte aligned, masked rows; each twice on normal values,
     bit-identical calls), K7 / K8
     (basis R-GCN aggregation and its backward at config 3, on an edge
     case, on rows above K7's piece length at d 100 and d 200 and on the
     power-law graph; bit-equal on dyadic inputs, then real values; K7
     twice on the power-law graph, bit-identical calls; K8 at B 128 and
     d 256, in column windows: one launch, equal to the plain backward),
     K5 (segment-max at the RGAT path's shape, the FB15k-237 in-half,
     the power-law graph and edge cases; twice on the power-law graph,
     bit-identical calls), K4a / K4b (the one-pass compose and backward
     products, bit-equal on any input, also ragged and
     misaligned), K3 (the stacked fused compose + segment-sum at the
     stacked WN18RR and FB15k-237 views, on the power-law graph and on an
     edge case at d 37; bit-equal on dyadic inputs, also without the
     padding edges, then real values; twice on the power-law graph's real
     values, bit-identical calls);
  4. timing: each kernel, its plain version and the one-call library
     equivalent or yardstick, with CUDA events, beside the least time the
     card needs (K1, K3, K5, K7, K8 also without the graph's padding edges,
     K1, K3, K5, K7, K8 also on the power-law graph, K5 also at the
     FB15k-237 in-half (with and without its padding edges) with its
     profiler interval, K3 also at the stacked
     FB15k-237 view, K7, K8 also at a second layer's d 200, K8 also at
     B 128 and d 256 (column windows), K1's, K3's and K7's two passes
     apart, K2a / K2b also at the
     FB15k-237 shape and beside the yardsticks of one addmm and of K2b's
     three products, K2a's two passes apart and K2a at every shape of its
     check; phase 5 also gives K2a's device time in the fused step);
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
     encode;
 12. the model surface: (a) MGCN + ConvE at the WN18RR preset's widths with
     2 layers (100 -> 200 -> 200) and the corr composition on the corpus of
     phase 5: 50 timed steps (K1 8 a step), one kernel step against the
     plain step, one CLI epoch (--num_layers 2 --composition corr), its
     checkpoint served through the CLI with --do_test --per_relation
     (per_relation.json checked against the corpus metrics) and
     --do_predict, and its kernel encode held against the plain encode;
     (b) the decoders at their presets' widths, 10 timed steps each and one
     kernel step against the plain step: MGCN + ComplEx on the fused loss
     (K1 4, K2a 1, K2b 1), MGCN + TransE and + RotatE (dense loss, K1 4) on
     the corpus of phase 5, R-GCN config 3 with ComplEx and with RotatE on
     negatives (K1 2, K7 2, K8 2) on the corpus of phase 7; (c) BASELINE
     config 4, MGCN + ConvE at the WN18RR preset on K = E/8 sampled edges
     per half (bench.py's sampled mode): 50 timed steps (no kernel: the
     sample is summed by index_add_), one CLI epoch (--edge_sample_size),
     whose full-graph validation launches K1, its checkpoint served through
     the CLI and its kernel encode held against the plain encode;
 13. the last single-device modules, 20 timed steps and one kernel step
     against the plain step (the same knob, warm Adam state) each: (a)
     bench.py's fb15k_cb (MGCN + ConvE at the FB15k-237 preset's widths,
     use_pallas, float32, KGC_MGCN_CONTRIB=bf16; K1 4) and (b) rgcn_best
     (config 3, KGC_BASIS_READBACK=bf16; K1 2, K7 2, K8 2) on the corpus of
     phase 7; (c) rgcn_block (config 3 with 10 blocks; K1 4, peak memory),
     then one CLI epoch (--num_blocks 10), its checkpoint served through the
     CLI and its kernel encode held against the plain encode; (d)
     rgat_pallas with KGC_EDGE_CONTRIB=bf16 (K5 2, K1 10); (e) MGCN halves
     at the WN18RR preset with bwd_perm operands and fwdw (K1 4), and one
     step's gradients of each against contrib's; (f) the CLI on data/Toy
     with --max_epoch 2 --profile_dir --ckpt_every 1 (the trace of epoch 2
     names K1's kernel, periodic.orbax equals the final parameters, epoch 2
     has no steps_per_s), and the trace's bound at the WN18RR preset
     (TRACE_STEPS steps recorded of 10 more: size, events, seconds with and
     without it, host memory); (g) phase 5's weights written by
     save_reference_checkpoint and served through --restore_torch, whose
     encode equals phase 6's to the bit;
 14. the host data engine and the edge-partitioned multi-GPU path, its
     ranks subprocesses of this script (``--rank``) on the one card, which
     share it over gloo (NCCL refuses two ranks on one device), each world
     under a timeout: (a) the engine at FB15k-237's counts on the card's
     host: load and build_graph with numpy and with C++ (equal field for
     field), the C++ locality order, host seconds; (b) MGCN + ConvE at the
     WN18RR preset (use_pallas, dropout off) and (d) RGAT + DistMult, 4
     heads, at graph_axis 2 on the corpus of phase 5; (c) MGCN at
     data_axis 2 (sparse and fused loss) and at data_axis 2 x graph_axis 2
     on the plan's short last batch: each rank's step launches (K1 4; RGAT
     K1 10, K5 2; fused K2a 1, K2b 1 more), rank 0 holds the loss, every
     gradient (the per-edge table gathered) and every update against the
     one-process kernel step after 3 warm steps (same weights, Adam state,
     batch and ReLU sides), and each rank profiles 3 steps (K1's and K5's
     device µs, busy, host ms); the collectives on CUDA tensors checked
     first; (e) the CLI on two ranks (--graph_axis 2 --partition locality,
     2 epochs on data/Toy), --do_test of its checkpoint on two ranks and in
     one process (equal metrics); (f) a world of one rank on NCCL, one
     step against the one-process step;
 15. the entity-sharded schedules (--entity_sharded), ranks of this script
     sharing the card over gloo, at the WN18RR preset's widths on the corpus
     of phase 5, dropout off: at graph_axis 2 one training step each of
     MGCN + ConvE with use_pallas on gather (K1 4 a step per rank) and on
     boundary (K1 per block) and plain on each of the three, basis R-GCN
     + DistMult on each of the three schedules (plain, as in the JAX
     package) and RGAT + DistMult on gather (K5 2, K1 10; and through the
     plain versions), and at
     graph_axis 4 MGCN (ring, boundary with K1) and R-GCN (ring,
     boundary): rank 0 holds each step against the one-process kernel step
     after 3 warm steps (same weights, Adam state, batch and ReLU sides,
     the entity rows' sides cut to the rank's rows), each rank times one
     more step; the bytes a rank moves per layer under each schedule,
     counted on the host from the plans; then the CLI on two ranks
     (--graph_axis 2 --entity_sharded boundary --use_pallas --partition
     locality, 1 epoch on data/Toy) and --do_test of its checkpoint on the
     two ranks and in one process (equal metrics);
 16. the rest of the edge-partitioned path, ranks of this script sharing
     the card over gloo, at the WN18RR preset's widths on the corpus of
     phase 5, dropout off, graph_axis 2: (a) one MGCN + ConvE step on K =
     E/8 sampled edges a half, the ranks given the positions of the
     one-process step, and (b) one step of the bench's
     agg_schedule=reference (both index_add_, no kernel, as in the JAX
     package), rank 0 holding each against the one-process step after 3
     warm steps; (c) the CLI on two ranks (--graph_axis 2 --use_pallas
     --ckpt_every 1, 1 epoch on data/Toy), which write last.orbax and
     periodic.orbax, each rank reporting its own chunks, then --do_test
     --do_predict of last.orbax on the two ranks (K1 4 on each: two
     encodes of its slices; rank 1 prints nothing) and in one process:
     equal metrics, the same top-10 (scores within 1e-5);
 17. --remat (the encoder recomputed in the backward) at the WN18RR
     preset's widths on the corpus of phase 5, dropout on: on each path
     (MGCN halves, fused loss, ew_impl=pallas, stacked, stacked_xla, 2
     layers corr, K = E/8 sampled edges, KGC_MGCN_CONTRIB=bf16; R-GCN basis
     and block, 1-vs-all; RGAT), after 2 warm steps, the plain step twice
     and the remat step from one state (tools/remat_probe.py), with
     PyTorch's default and with its deterministic algorithms: the loss,
     gradients, parameters, BN statistics and generator state bit-equal
     where the plain step repeats to the bit, else within the kernel step's
     tolerances, and the remat step's launches the plain step's plus one
     encoder forward's (each kernel of the path's recompute among them);
     the peak memory and ms a step with and without --remat at WN18RR's
     proportions times 1 and 4 (MGCN + ConvE, batch 128, float32, K1); one
     CLI epoch with --remat (K1 6 a step).
K1, K3, K7 and K8 checks use dyadic inputs, whose float32 sums are exact in
any order, so kernel and plain version must agree to the bit; K5
(segment-max, phase 3: the RGAT path's shape and edge cases), K4a and K4b
(products in the plain version's order) are exact on any input.
The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.  Before them a line gives the card, its
power limit and the wall seconds of the whole script and of phases 12,
13, 14, 15, 16 and 17.
Nothing of JAX is imported.

--kernels-only runs phases 1-3 and the time rows of K1, K2a, K7 and K3 (each
with its two passes' device times), K2b, K8 and K5, then prints their entries and
the last line: a quick check of the kernels that drives no path (their
launch counts are 0).  --mesh-only runs phases 1-2 and 14, then the last
line.  --entity-only runs phases 1-2 and 15 (the entity-sharded
schedules, ~125 s of card time with its own references), then the last
line.  --rest-only runs phases 1-2 and 16, then the last line.
--remat-only runs phases 1-2 and 17, then the last line.
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
# a ReLU input that rounds to the other side of 0 in the two steps flips that
# element's derivative between 0 and 1, so the gradients upstream of it differ
# by a whole term, not by rounding (one such element of ConvE's bn1 output
# moves conv_w's gradient by several times STEP_ATOL).  The plain step takes
# the kernel step's side of every kink (KinkReplay); an element whose side
# differs must lie within KINK_TOL x the largest input of its call
KINK_TOL = 1e-4
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
# phase 13c's block-mode CLI epoch: above this estimate the corpus keeps
# its entities and relations and has fewer train triples
BLOCK_EPOCH_LIMIT_S = 45.0
TIMED_STEPS = 50
# WN18RR's and FB15k-237's counts (scripts/make_synth_corpus.py): entities,
# relations, train / valid / test triples
WN18RR = (40943, 11, 86835, 3000, 3000)
FB15K237 = (14541, 237, 272115, 17535, 20466)
# K7's two kernels (csrc/basis_rgcn.cu), as the profiler names them; timed
# with overlap=False, so that pass B's interval holds no wait for pass A
K7_PASSES = ("basis_sum_kernel", "basis_fixup_kernel")
# K3's two kernels (csrc/fused_compose.cu); pass B is a plain second launch
K3_PASSES = ("chunk_compose", "split_rows")
# K2a's two launches: the pass over entity tiles, the sum of its partials
K2A_PASSES = ("loss_tiles", "sum_partials")


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


def basis_sum_bound(e: int, n_rows: int, d: int, nb: int):
    """K7: msg, a and indptr read once, out (n_rows, B*d) written once;
    2*E*B*d operations."""
    return bound_of(4 * (e * d + e * nb + n_rows + 1 + n_rows * nb * d),
                    2.0 * e * nb * d)


def basis_bwd_bound(e: int, rows: int, d: int, nb: int):
    """K8: dst, msg and a read once, g read once for each of the ``rows``
    rows that have edges (K8 reads no other row of g), d_msg and d_a
    written once; 4*E*B*d operations."""
    return bound_of(4 * (rows * nb * d + 2 * e * d + 2 * e * nb + e),
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
    """(wall µs, device-busy µs, every kernel by device µs, top PyTorch ops
    by self device µs) per call of ``fn`` under torch.profiler; busy is 0.0
    if the profiler saw no kernel."""
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
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


def kinds_us(top, kinds) -> tuple:
    """Device µs per call summed over the kernels of ``top`` whose names
    hold each of ``kinds``; None for a kind the profiler did not see."""
    return tuple(sum(t for kernel, t in top if kind in kernel)
                 if any(kind in kernel for kernel, _ in top) else None
                 for kind in kinds)


def log_profile(what: str, fn, steps: int = 3, kinds=()) -> dict:
    """Logs a profile of ``fn``; with ``kinds``, also the device µs of the
    kernels whose names hold each (``kinds_us``), under "kinds_us"."""
    wall, busy, top, ops = profile_kernels(fn, steps)
    if busy == 0.0:
        log(f"[profile] {what}: device time not measured (the profiler saw "
            "no kernel)")
        return {}
    log(f"[profile] {what}: wall {wall:.1f} us, device busy {busy:.1f} us, "
        f"idle {1 - busy / wall:.1%}; top kernels: "
        + "; ".join(f"{n[:90]} {t:.1f} us" for n, t in top[:10]))
    if ops:
        log(f"[profile] {what}: top ops by self device time: "
            + "; ".join(f"{n} {t:.1f} us x{c}" for n, t, c in ops))
    out = {"wall_us": wall, "busy_us": busy, "idle": 1 - busy / wall}
    if kinds:
        out["kinds_us"] = dict(zip(kinds, kinds_us(top, kinds)))
        log(f"[profile] {what}: device µs per call of the kernels "
            + ", ".join(f"{k} {us(v)}" for k, v in out["kinds_us"].items()))
    return out


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


def csr(counts):
    """(dst (E,) int32, indptr (n_rows+1,) int32) on the host, for the given
    per-row edge counts."""
    counts = torch.as_tensor(counts, dtype=torch.int64)
    indptr = torch.zeros(len(counts) + 1, dtype=torch.int32)
    indptr[1:] = torch.cumsum(counts, 0)
    dst = torch.repeat_interleave(torch.arange(len(counts)), counts).int()
    return dst, indptr


def config3(seed: int):
    """BASELINE config 3: basis R-GCN (30 bases) + DistMult on negatives,
    float32, the FB15k-237 preset's widths, lr and dropout."""
    from kgc_gcn_torch.config import dataset_preset
    return dataset_preset("FB15k-237", model="rgcn", decoder="distmult",
                          num_bases=30, train_mode="negative_sampling",
                          compute_dtype="float32", moment_dtype="float32",
                          seed=seed)


def csr_case(counts, d: int, dtype, gen):
    dst, indptr = csr(counts)
    msg = dyadic(len(dst), d, dtype, gen)
    return (msg.cuda(), dst.cuda(), indptr.cuda(), len(counts))


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
    from kgc_gcn_torch.parallel.edge_parallel import local_half
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
        # KGC_EDGE_CONTRIB=bf16: the edge message's d_h in bf16 (the MGCN
        # and basis streams are fb15k237_src_bf16's shape)
        "wn18rr_src_d200_bf16": half_case(graph.inb, n_wn, 200, bf16, gen,
                                          "src"),
        # power-law hubs (no padding) and FB15k-237's rel order in float32
        "fb15k237_powerlaw_f32": csr_case(power_counts, d, f32, gen),
        "fb15k237_powerlaw_bf16": csr_case(power_counts, d, bf16, gen),
        "fb15k237_rel_f32": half_case(fb_graph.outb, n_fb, d, f32, gen,
                                      "rel"),
        # graph_axis 2 (phase 14): each rank's slice of the in-half over
        # all N rows, in its local dst order
        **{f"wn18rr_shard{r}of2_f32": half_case(local_half(graph.inb, 2, r),
                                                n_wn, d, f32, gen)
           for r in range(2)},
    }


def time_basis(fb_in, pl_dst, pl_ptr, cfg3, gen) -> dict:
    """K7 / K8 time rows at config 3 (FB15k-237 in-half, B 30, d 100): the
    kernel, its plain version, its yardstick and its bound, and the kernel
    without the 269 zero-norm padding edges (msg, a and dst cut to the first
    e_real edges, indptr[-1] = e_real).  Yardsticks (no one PyTorch call
    computes either function): K7, index_add_ of the pre-built (E, B*d)
    expansion; K8, the two einsums on a pre-gathered sel = g[dst].  The
    basis contraction that follows K7 in the encoder, (N, B*d) @ (B*d,
    d_out), is timed beside them, and K7 and K8 at a second layer's d 200 on
    the same graph, and K8 at B 128 and d 256 (column windows; its plain
    version would gather 35.7 GB).  Then both kernels and their bounds on
    the power-law graph at config 3's widths.  K7's passes A and B also get
    their device µs per call from the profiler, at config 3 and on the
    power-law graph, with pass B launched after pass A (overlap=False)."""
    from kgc_gcn_torch.ops.basis import (
        basis_backward, basis_backward_reference, basis_segment_sum,
        basis_segment_sum_reference)
    n_fb, nb3, d3 = FB15K237[0], cfg3.num_bases, cfg3.gcn_in_dim
    d2 = cfg3.gcn_out_dim
    msg, a, dd, ip, g = basis_case(fb_in.dst, fb_in.indptr, n_fb, d3, nb3,
                                   gen, real=True)
    msg2 = torch.randn(msg.shape[0], d2, generator=gen).cuda()
    g2 = torch.randn(n_fb, nb3 * d2, generator=gen).cuda()
    msg_w = torch.randn(msg.shape[0], 256, generator=gen).cuda()
    a_w = torch.randn(msg.shape[0], 128, generator=gen).cuda()
    g_w = torch.randn(n_fb, 128 * 256, generator=gen).cuda()
    e3, e_real = msg.shape[0], fb_in.e_real
    rows = int((ip[1:] > ip[:-1]).sum())
    cut = ip.clone()
    cut[-1] = e_real
    msg_r, a_r, dd_r = msg[:e_real], a[:e_real], dd[:e_real]
    expansion = (msg[:, None, :] * a[:, :, None]).reshape(e3, -1)
    sel = g[dd.long()].view(e3, nb3, d3)
    lib_out = torch.zeros(n_fb, nb3 * d3, device=msg.device)
    dst_long = dd.long()
    basis_w = torch.randn(nb3 * d3, d2, generator=gen).to(msg.device)
    agg = basis_segment_sum(msg, a, dd, ip, n_fb)
    t = time_in_turns({
        "K7": lambda: basis_segment_sum(msg, a, dd, ip, n_fb),
        "K7_plain": lambda: basis_segment_sum_reference(msg, a, dd, ip, n_fb),
        "K7_yardstick": lambda: lib_out.index_add_(0, dst_long, expansion),
        "K7_without_padding": lambda: basis_segment_sum(msg_r, a_r, dd_r, cut,
                                                        n_fb),
        "K8": lambda: basis_backward(g, msg, a, dd, ip),
        "K8_plain": lambda: basis_backward_reference(g, msg, a, dd, ip),
        "K8_yardstick": lambda: (torch.einsum("ebd,eb->ed", sel, a),
                                 torch.einsum("ebd,ed->eb", sel, msg)),
        "K8_without_padding": lambda: basis_backward(g, msg_r, a_r, dd_r, cut),
        "K8_d200": lambda: basis_backward(g2, msg2, a, dd, ip),
        "K7_d200": lambda: basis_segment_sum(msg2, a, dd, ip, n_fb),
        "K8_b128_d256": lambda: basis_backward(g_w, msg_w, a_w, dd, ip),
        "basis_matmul": lambda: agg @ basis_w,
    }, n=50)
    t["K7_bound"], t["K7_bound_by"] = basis_sum_bound(e3, n_fb, d3, nb3)
    t["K7_d200_bound"], _ = basis_sum_bound(e3, n_fb, d2, nb3)
    t["K7_pass_a_us"], t["K7_pass_b_us"] = passes_us(
        lambda: basis_segment_sum(msg, a, dd, ip, n_fb, overlap=False),
        K7_PASSES)
    t["K8_bound"], t["K8_bound_by"] = basis_bwd_bound(e3, rows, d3, nb3)
    t["K8_d200_bound"], _ = basis_bwd_bound(e3, rows, d2, nb3)
    t["K8_b128_d256_bound"], _ = basis_bwd_bound(e3, rows, 256, 128)
    log_profile("K7 at config 3", lambda: basis_segment_sum(msg, a, dd, ip, n_fb),
                steps=5)
    log_profile("K8 at config 3", lambda: basis_backward(g, msg, a, dd, ip),
                steps=5)
    for key, what in (("K7", "index_add_ of the pre-built expansion"),
                      ("K8", "two einsums on a pre-gathered sel")):
        log(f"[{key} time] config 3 (E {e3}, N {n_fb}, {n_fb - rows} rows "
            f"without edges, B {nb3}, d {d3}): "
            f"kernel {t[key]:.4f} ms, plain {t[f'{key}_plain']:.4f} ms, "
            f"yardstick ({what}) {t[f'{key}_yardstick']:.4f} ms, bound "
            f"{t[f'{key}_bound']:.4f} ms ({t[f'{key}_bound_by']}), "
            f"{t[f'{key}_bound'] / t[key]:.1%} of bound; without the "
            f"{e3 - e_real} padding edges {t[f'{key}_without_padding']:.4f}"
            " ms")
    for key in ("K7", "K8"):
        log(f"[{key} time] config 3's graph at d {d2} (B {nb3}): kernel "
            f"{t[f'{key}_d200']:.4f} ms, bound {t[f'{key}_d200_bound']:.4f} "
            f"ms, {t[f'{key}_d200_bound'] / t[f'{key}_d200']:.1%} of bound")
    log(f"[K8 time] config 3's graph at B 128, d 256 (two windows of 128 "
        f"columns): kernel {t['K8_b128_d256']:.4f} ms, bound "
        f"{t['K8_b128_d256_bound']:.4f} ms, "
        f"{t['K8_b128_d256_bound'] / t['K8_b128_d256']:.1%} of bound")
    log(f"[K7 time] config 3: passes A / B {us(t['K7_pass_a_us'])} / "
        f"{us(t['K7_pass_b_us'])} µs (pass B after pass A)")
    log(f"[basis contraction] (N {n_fb}, {nb3 * d3}) @ ({nb3 * d3}, "
        f"{d2}) float32: {t['basis_matmul']:.4f} ms "
        f"({2 * n_fb * nb3 * d3 * d2 / t['basis_matmul'] / 1e9:.1f}"
        " TFLOP/s)")
    del msg, a, g, msg2, g2, expansion, sel, lib_out, agg, msg_r, a_r, dd_r
    del msg_w, a_w, g_w
    msg, a, dd, ip, g = basis_case(pl_dst, pl_ptr, n_fb, d3, nb3, gen,
                                   real=True)
    e_pl = msg.shape[0]
    rows = int((ip[1:] > ip[:-1]).sum())
    expansion = (msg[:, None, :] * a[:, :, None]).reshape(e_pl, -1)
    lib_out = torch.zeros(n_fb, nb3 * d3, device=msg.device)
    dst_long = dd.long()
    tp = time_in_turns({
        "K7": lambda: basis_segment_sum(msg, a, dd, ip, n_fb),
        "K8": lambda: basis_backward(g, msg, a, dd, ip),
        "K7_yardstick": lambda: lib_out.index_add_(0, dst_long, expansion),
    }, n=50)
    t["K7_powerlaw_yardstick"] = tp["K7_yardstick"]
    t["K7_powerlaw_pass_a_us"], t["K7_powerlaw_pass_b_us"] = passes_us(
        lambda: basis_segment_sum(msg, a, dd, ip, n_fb, overlap=False),
        K7_PASSES)
    log(f"[K7 time] power law: yardstick (index_add_ of the pre-built "
        f"expansion) {tp['K7_yardstick']:.4f} ms; passes A / B "
        f"{us(t['K7_powerlaw_pass_a_us'])} / "
        f"{us(t['K7_powerlaw_pass_b_us'])} µs (pass B after pass A)")
    for key in ("K7", "K8"):
        b_ms, b_by = (basis_bwd_bound(e_pl, rows, d3, nb3) if key == "K8" else
                      basis_sum_bound(e_pl, n_fb, d3, nb3))
        t[f"{key}_powerlaw"] = tp[key]
        t[f"{key}_powerlaw_bound"] = b_ms
        log(f"[{key} time] power law (E {e_pl}, N {n_fb}, {n_fb - rows} rows "
            f"without edges, largest row {int((ip[1:] - ip[:-1]).max())} "
            f"edges, B {nb3}, d {d3}): kernel {tp[key]:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), {b_ms / tp[key]:.1%} of bound")
    del msg, a, g, expansion, lib_out
    torch.cuda.empty_cache()
    return t


def passes_us(fn, kinds):
    """Device µs per call of ``fn`` under the profiler, summed over the
    kernels whose names hold each of ``kinds`` (a kernel's two passes);
    None for a kind whose kernel the profiler did not see."""
    return kinds_us(profile_kernels(fn, 5)[2], kinds)


def us(v) -> str:
    """A device time from ``passes_us``, or "not measured"."""
    return "not measured" if v is None else f"{v:.1f}"


def basis_entries(basis_errs: dict, t: dict, by_path7: dict,
                  by_path8: dict) -> list:
    """K7's and K8's entries of the kernels line, from ``time_basis``'s
    rows and the launches of the paths driven."""
    entries = []
    for key, fn_name, line, yard, by_path in (
            ("K7", "basis_sum", 918, "index_add_ of the pre-built expansion",
             by_path7),
            ("K8", "basis_bwd", 1181, "two einsums on a pre-gathered sel",
             by_path8)):
        entries.append({
            "name": f"{fn_name} ({key})", "route": "cuda",
            "source": "kgc_gcn_torch/csrc/basis_rgcn.cu",
            "replaces": f"kgc_gcn_tpu/ops/spmm_pallas.py:{line}",
            "launches": sum(by_path.values()),
            "max_abs_err": max(basis_errs[key].values()),
            "ms": t[key], "plain_ms": t[f"{key}_plain"],
            "bound_ms": t[f"{key}_bound"], "bound_by": t[f"{key}_bound_by"],
            "library_ms": None, "yardstick": yard,
            "yardstick_ms": t[f"{key}_yardstick"],
            "ms_without_padding": t[f"{key}_without_padding"],
            "ms_powerlaw": t[f"{key}_powerlaw"],
            **({"yardstick_ms_powerlaw": t["K7_powerlaw_yardstick"],
                "pass_a_us": t["K7_pass_a_us"], "pass_b_us": t["K7_pass_b_us"],
                "pass_a_us_powerlaw": t["K7_powerlaw_pass_a_us"],
                "pass_b_us_powerlaw": t["K7_powerlaw_pass_b_us"]}
               if key == "K7" else {}),
            "bound_ms_powerlaw": t[f"{key}_powerlaw_bound"],
            "ms_d200": t[f"{key}_d200"],
            "bound_ms_d200": t[f"{key}_d200_bound"],
            **({"ms_b128_d256": t["K8_b128_d256"],
                "bound_ms_b128_d256": t["K8_b128_d256_bound"]}
               if key == "K8" else {}),
            "launches_by_path": by_path,
            "cases": {"max_abs_err": basis_errs[key]},
        })
    return entries


def k3_cases(ds, graph, fb_graph, pl_dst, pl_ptr, hub_dst, hub_ptr, d: int,
             gen, device, real: bool) -> dict:
    """K3's operands on the card, name -> (x, src, norm, rel_all, rel,
    etab, dst, indptr, n_rows): the stacked views of the WN18RR-shaped corpus
    and of the FB15k-237-shaped graph (both halves' 2 E_pad edges over 2N
    rows and the 2R+1 relation rows; rows N-1 and 2N-1 hold the padding
    edges), the power-law in-degrees as CSR (random src over FB15k-237's
    entities, rel over its 475 relation rows), all at width ``d``, and an
    edge case on the hub counts at d 37 (empty rows, a 5,000-edge hub row,
    40 entities).  Dyadic operands (multiples of 2**-3 below 1: every
    product and partial sum exact in float32; the stacked views' padding
    edges keep their zero norm), or normal values with ``real`` (the
    stacked views with their own norms)."""
    draw = ((lambda *sh: torch.randn(*sh, generator=gen)) if real else
            (lambda *sh: torch.randint(-7, 8, sh, generator=gen) / 8))
    ids = lambda n, hi: torch.randint(0, hi, (n,), generator=gen).int()
    n_wn, n_fb = ds.num_entity, FB15K237[0]
    r_wn, r_fb = 2 * ds.num_relation + 1, 2 * FB15K237[1] + 1
    e_pl, e_hub = pl_dst.shape[0], hub_dst.shape[0]
    layouts = {
        "wn18rr_stacked": (graph.stacked, n_wn, r_wn, d),
        "fb15k237_stacked": (fb_graph.stacked, n_fb, r_fb, d),
        "powerlaw": ((ids(e_pl, n_fb), ids(e_pl, r_fb), None, pl_dst, pl_ptr),
                     n_fb, r_fb, d),
        "edge_d37": ((ids(e_hub, 40), ids(e_hub, r_wn), None, hub_dst,
                      hub_ptr), 40, r_wn, 37)}
    cases = {}
    for name, (lay, n_x, n_rel, width) in layouts.items():
        if not isinstance(lay, tuple):
            lay = (lay.src, lay.rel, lay.norm, lay.dst2, lay.indptr)
        src, rel, norm, dst, ptr = lay
        e = src.shape[0]
        nm = draw(e)
        if norm is not None:   # the padding edges keep their zero norm
            nm = norm if real else nm * (norm != 0)
        cases[name] = [t.to(device) for t in (
            draw(n_x, width), src, nm, draw(n_rel, width), rel,
            draw(e, width), dst, ptr)] + [ptr.shape[0] - 1]
    return cases


def without_padding(args, graph):
    """K3's operands at the stacked WN18RR view without the zero-norm
    padding edges of rows N-1 and 2N-1: the same rows, the same sums."""
    x, src, nm, rel_all, rel, et, dst, ip, n_rows = args
    keep = torch.cat([torch.arange(graph.inb.e_real),
                      graph.e_pad + torch.arange(graph.outb.e_real)]
                     ).to(x.device)
    dst_cut = dst[keep].contiguous()
    ip_cut = torch.zeros_like(ip)
    ip_cut[1:] = torch.cumsum(torch.bincount(dst_cut.long(),
                                             minlength=n_rows), 0)
    return (x, src[keep].contiguous(), nm[keep].contiguous(), rel_all,
            rel[keep].contiguous(), et[keep].contiguous(), dst_cut, ip_cut,
            n_rows)


def time_k3(fused, plain, cases: dict, graph) -> dict:
    """K3's time rows on normal operands (``k3_cases(real=True)``) at the
    stacked WN18RR and FB15k-237 views and on the power-law graph: the
    kernel ``fused``, its plain version, its yardstick and its bound; at
    WN18RR also without the 410 padding edges (``without_padding``).  The
    yardstick is index_add_ of the precomposed messages into the same rows,
    as K7's is (no one PyTorch call composes and sums).  Each pass's device
    µs per call comes from the profiler (None where it saw no such kernel)."""
    out = {}
    for name in ("wn18rr_stacked", "fb15k237_stacked", "powerlaw"):
        args = cases[name]
        x, src, nm, rel_all, rel, et, dst, ip, n_rows = args
        msg_pre = ((x[src.long()] * nm[:, None]) * rel_all[rel.long()]) * et
        lib_out = torch.zeros(n_rows, x.shape[1], device=x.device)
        dst_long = dst.long()
        fns = {"ms": lambda: fused(*args),
               "plain_ms": lambda: plain(*args),
               "yardstick_ms": lambda: lib_out.index_add_(0, dst_long,
                                                          msg_pre)}
        if name == "wn18rr_stacked":
            cut = without_padding(args, graph)
            fns["ms_without_padding"] = lambda: fused(*cut)
        t = time_in_turns(fns)
        t["bound_ms"], t["bound_by"] = k3_bound(
            x.shape[0], rel_all.shape[0], et.shape[0], n_rows, x.shape[1])
        t["pass_a_us"], t["pass_b_us"] = passes_us(lambda: fused(*args),
                                                   K3_PASSES)
        line = (f" (passes A / B {us(t['pass_a_us'])} / "
                f"{us(t['pass_b_us'])} µs)")
        if "ms_without_padding" in t:
            line += (f"; without the {et.shape[0] - cut[5].shape[0]} padding "
                     f"edges {t['ms_without_padding']:.4f} ms")
        counts = ip[1:] - ip[:-1]
        log(f"[K3 time] {name} (E {et.shape[0]}, rows {n_rows}, d "
            f"{x.shape[1]}, {rel_all.shape[0]} relation rows, largest row "
            f"{int(counts.max())} edges): kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, yardstick (index_add_ of the "
            f"precomposed messages) {t['yardstick_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), "
            f"{t['bound_ms'] / t['ms']:.1%} of bound{line}")
        out[name] = t
        del msg_pre, lib_out, fns
    return out


def k3_entry(k3_errs: dict, t: dict, by_path: dict) -> dict:
    """K3's entry of the kernels line: the stacked WN18RR view's times,
    every timed case's rows, and the launches of the paths driven."""
    main_t = t["wn18rr_stacked"]
    return {
        "name": "fused_compose (K3)", "route": "cuda",
        "source": "kgc_gcn_torch/csrc/fused_compose.cu",
        "replaces": "kgc_gcn_tpu/ops/spmm_pallas.py:267",
        "launches": sum(by_path.values()),
        "max_abs_err": max(k3_errs.values()),
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": None,
        "yardstick": "index_add_ of the precomposed messages",
        "yardstick_ms": main_t["yardstick_ms"],
        "ms_without_padding": main_t["ms_without_padding"],
        "launches_by_path": by_path,
        "cases": {**{name: dict(row) for name, row in t.items()},
                  "max_abs_err": k3_errs},
    }


def time_k5(segment_max, segment_max_reference, max_cases: dict,
            e_real: dict) -> dict:
    """K5's time rows: at the RGAT path's shape and the FB15k-237 in-half
    (each also without its padding edges: indptr[-1] = ``e_real[name]``)
    and the power-law graph, each beside its plain version, one library call
    (``torch.segment_reduce`` max over the CSR lengths where it gives the
    plain version's result, -inf on empty rows; else ``scatter_reduce_``
    amax), its bound (logits, indptr and out once) and the kernel's profiler
    interval."""
    out = {}
    for name in ("wn18rr_h4", "fb15k237_h4", "powerlaw_h4"):
        lg, dd, ip, n_rows = max_cases[name]
        lengths = (ip[1:] - ip[:-1]).long()
        seg_reduce = lambda: torch.segment_reduce(lg, "max", lengths=lengths,
                                                  axis=0, unsafe=True)
        want = segment_max_reference(lg, dd, ip, n_rows)
        if torch.equal(seg_reduce(), want):
            library, library_name = seg_reduce, "torch.segment_reduce max"
        else:
            idx = dd.long()[:, None].expand(-1, lg.shape[1])
            library, library_name = (
                lambda: torch.full_like(want, -math.inf).scatter_reduce_(
                    0, idx, lg, "amax"), "scatter_reduce_ amax")
        fns = {"ms": lambda: segment_max(lg, dd, ip, n_rows),
               "plain_ms": lambda: segment_max_reference(lg, dd, ip, n_rows),
               "library_ms": library}
        pad = ""
        if name in e_real:
            cut = ip.clone()
            cut[-1] = e_real[name]
            fns["ms_without_padding"] = lambda: segment_max(lg, dd, cut, n_rows)
        t = time_in_turns(fns)
        t["bound_ms"], t["bound_by"] = max_bound(lg.shape[0], lg.shape[1],
                                                 n_rows)
        t["library"] = library_name
        t["kernel_us"] = log_profile(
            f"K5 {name}", fns["ms"], steps=5,
            kinds=("segment_max_kernel",)).get(
                "kinds_us", {}).get("segment_max_kernel")
        if name in e_real:
            pad = (f"; without the {lg.shape[0] - e_real[name]} padding "
                   f"edges {t['ms_without_padding']:.4f} ms")
        out[name] = t
        log(f"[K5 time] {name} (E {lg.shape[0]}, H {lg.shape[1]}, rows "
            f"{n_rows}, largest row {int(lengths.max())}): kernel "
            f"{t['ms']:.4f} ms ({us(t['kernel_us'])} µs under the profiler), "
            f"plain {t['plain_ms']:.4f} ms, {library_name} "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}), {t['bound_ms'] / t['ms']:.1%} of bound{pad}")
    return out


def k5_entry(max_errs: dict, t: dict, launches_by_path: dict) -> dict:
    """K5's entry of the kernels line: the RGAT path's shape (WN18RR in-half,
    H 4) first, every timed shape, and the check's errors."""
    t5 = t["wn18rr_h4"]
    return {
        "name": "segment_max (K5)", "route": "cuda",
        "source": "kgc_gcn_torch/csrc/segment_max.cu",
        "replaces": "kgc_gcn_tpu/ops/spmm_pallas.py:801",
        "launches": sum(launches_by_path.values()),
        "max_abs_err": max(max_errs.values()),
        "ms": t5["ms"], "plain_ms": t5["plain_ms"],
        "bound_ms": t5["bound_ms"], "bound_by": t5["bound_by"],
        "library_ms": t5["library_ms"], "library": t5["library"],
        "ms_without_padding": t5["ms_without_padding"],
        "kernel_us": t5["kernel_us"],
        "shapes": t,
        "launches_by_path": launches_by_path,
        "cases": {"max_abs_err": max_errs},
    }


def k2_case(b: int, n: int, d: int, masked, gen, offset: int = 0):
    """h, ent, bias, row mask as the training path gives them: h after
    ReLU, entities after tanh, a small bias, padding rows masked; h and ent
    start ``offset`` floats into their buffers on the card (1: no longer
    16-byte aligned)."""
    h = torch.relu(torch.randn(b, d, generator=gen))
    ent = torch.tanh(torch.randn(n, d, generator=gen))
    bias = torch.randn(n, generator=gen) * 0.1
    w = torch.ones(b)
    w[list(masked)] = 0.0

    def at_offset(t):
        view = torch.empty(t.numel() + offset, device="cuda")[offset:]
        return view.view(t.shape).copy_(t)
    return [at_offset(h), at_offset(ent), bias.cuda(), w.cuda()]


def time_k2(name: str, h, ent, bias, w, profile: bool = False) -> dict:
    """K2a / K2b time rows: each kernel, its plain version and its bound,
    beside two yardsticks (no one PyTorch call computes either function):
    the score product addmm(bias, h, ent.T), and K2b's three products
    timed together on a precomputed dl (addmm, dl @ ent, dl.T @ h); K2a's
    two passes' device µs per call from the profiler."""
    from kgc_gcn_torch.ops.fused_loss import (
        dense_grads, dense_grads_reference, dense_loss, dense_loss_reference)
    b, d = h.shape
    n = ent.shape[0]
    base = 1.0 / n
    g_t = torch.tensor(1.0 / (b * n), device=h.device)
    entT = ent.T
    dl = (torch.sigmoid(torch.addmm(bias, h, entT)) - base) * w[:, None] * g_t
    t = time_in_turns({
        "K2a": lambda: dense_loss(h, ent, bias, w, base),
        "K2a_plain": lambda: dense_loss_reference(h, ent, bias, w, base),
        "K2b": lambda: dense_grads(g_t, h, ent, bias, w, base),
        "K2b_plain": lambda: dense_grads_reference(g_t, h, ent, bias, w, base),
        "addmm": lambda: torch.addmm(bias, h, entT),
        "three_products": lambda: (torch.addmm(bias, h, entT), dl @ ent,
                                   dl.T @ h),
    })
    t["K2a_bound"], t["K2a_bound_by"] = k2_bound(b, n, d, False)
    t["K2b_bound"], t["K2b_bound_by"] = k2_bound(b, n, d, True)
    t["K2a_pass_a_us"], t["K2a_pass_b_us"] = passes_us(
        lambda: dense_loss(h, ent, bias, w, base), K2A_PASSES)
    if profile:
        log_profile(f"K2a at the {name} shape",
                    lambda: dense_loss(h, ent, bias, w, base), steps=5)
        log_profile(f"K2b at the {name} shape",
                    lambda: dense_grads(g_t, h, ent, bias, w, base), steps=5)
    log(f"[K2 time] {name} (B {b}, d {d}, N {n}): K2a {t['K2a']:.4f} ms "
        f"(passes A / B {us(t['K2a_pass_a_us'])} / {us(t['K2a_pass_b_us'])} "
        f"µs), plain {t['K2a_plain']:.4f} ms, yardstick addmm(bias, h, "
        f"ent.T) {t['addmm']:.4f} ms ({t['addmm'] / t['K2a']:.2f}x K2a), "
        f"bound {t['K2a_bound']:.4f} ms ({t['K2a_bound_by']}), "
        f"{t['K2a_bound'] / t['K2a']:.1%} of bound; "
        f"K2b {t['K2b']:.4f} ms, plain {t['K2b_plain']:.4f} ms, bound "
        f"{t['K2b_bound']:.4f} ms ({t['K2b_bound_by']}), "
        f"{t['K2b_bound'] / t['K2b']:.1%} of bound; yardstick K2b's three "
        f"products (addmm, dl @ ent, dl.T @ h) {t['three_products']:.4f} ms")
    return t


def time_k2a_cases(k2_cases: dict) -> dict:
    """K2a's median ms at every shape of the K2 check, timed in turns."""
    from kgc_gcn_torch.ops.fused_loss import dense_loss
    t = time_in_turns({
        name: (lambda a: lambda: dense_loss(*a, 1.0 / a[1].shape[0]))(args)
        for name, (args, _) in k2_cases.items()})
    log("[K2 time] K2a at every shape of the K2 check (ms): "
        + ", ".join(f"{name} {v:.4f}" for name, v in t.items()))
    return t


def k2_entries(k2_errs: dict, timings: dict, by_path_a: dict,
               by_path_b: dict) -> list:
    """K2a's and K2b's entries of the kernels line: the main shape's times,
    the FB15k-237 and edge shapes' rows, every case's error (K2a also its
    time at every shape of the check), and the launches of the paths
    driven."""
    main = timings["k2_main"]
    entries = []
    for key, fn_name, line, by_path in (
            ("K2a", "fused_bce_loss", 125, by_path_a),
            ("K2b", "fused_bce_grads", 145, by_path_b)):
        keep = lambda k: (k.startswith(key) or k == "addmm"
                          or (key == "K2b" and k == "three_products"))
        entries.append({
            "name": f"{fn_name} ({key})", "route": "cuda",
            "source": "kgc_gcn_torch/csrc/fused_score_bce.cu",
            "replaces": f"kgc_gcn_tpu/ops/fused_loss.py:{line}",
            "launches": sum(by_path.values()),
            "max_abs_err": max(k2_errs[key].values()),
            "ms": main[key], "plain_ms": main[f"{key}_plain"],
            "bound_ms": main[f"{key}_bound"],
            "bound_by": main[f"{key}_bound_by"],
            "library_ms": None,
            "yardstick": "addmm(bias, h, ent.T)",
            "yardstick_ms": main["addmm"],
            **({"yardstick_three_products_ms": main["three_products"]}
               if key == "K2b" else {
                   "pass_a_us": main["K2a_pass_a_us"],
                   "pass_b_us": main["K2a_pass_b_us"],
                   "check_cases_ms": timings["k2a_cases"]}),
            "launches_by_path": by_path,
            "cases": {**{name: {k: v for k, v in timings[f"k2_{name}"].items()
                                if keep(k)}
                         for name in ("fb15k237", "edge")},
                      "max_abs_err": k2_errs[key]},
        })
    return entries


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
                seed: int, kinds=(), steps: int = 0) -> dict:
    """3 set-up steps of ``trainer``'s epoch, then ``steps`` (default
    TIMED_STEPS) warm ones (steps/s, edges/s, peak memory, mean loss), each
    of which must launch ``per_step`` kernels; then a profile (with the
    device µs of the kernels named by ``kinds``)."""
    from kgc_gcn_torch.train import optim
    steps = steps or TIMED_STEPS
    host_rng = np.random.default_rng(seed)
    trainer.train_epoch(1, host_rng, max_steps=3)      # one-time set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.zero()
    t0 = time.perf_counter()
    loss = trainer.train_epoch(1, host_rng, max_steps=steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = launches.read()
    peak = torch.cuda.max_memory_allocated()
    want = tuple(steps * c for c in per_step)
    if got != want or not math.isfinite(loss):
        raise AssertionError(f"{what}: launches {Launches.show(got)}; want "
                             f"{Launches.show(want)}; loss {loss}")
    sps = steps / dt
    b, device = trainer.cfg.batch_size, trainer.device
    batch = trainer.batch(torch.arange(b, device=device),
                          torch.ones(b, device=device))
    lr = optim.epoch_lr(trainer.cfg, 1)
    prof = log_profile(f"one {what} training step",
                       lambda: trainer.train_step(lr, *batch), steps=3,
                       kinds=kinds)
    n_msgs = trainer.graph.num_messages
    log(f"[train] {what}: {steps} warm steps in {dt:.3f} s = "
        f"{sps:.2f} steps/s, {sps * n_msgs:.4g} edges/s (2E+N = {n_msgs}); "
        f"mean loss {loss:.6f}; launches per step "
        + ", ".join(f"{k} {c}" for k, c in zip(Launches.NAMES, per_step) if c)
        + f"; peak memory {peak} B; an epoch of {trainer.steps_per_epoch} "
        f"steps ~ {trainer.steps_per_epoch / sps:.1f} s")
    return {"steps_per_s": sps, "edges_per_s": sps * n_msgs,
            "peak_bytes": peak, "loss": loss, **prof,
            "launches_per_step": dict(zip(Launches.NAMES,
                                          (c / steps for c in got)))}


class KinkReplay:
    """Records which side of 0 every ``torch.relu`` and ``leaky_relu`` input
    of one step lies on, and makes a second step of the same code take the
    same sides, call by call: both steps then differentiate the same linear
    piece.  ``ties`` counts the elements whose side the replay decided."""

    def __init__(self):
        self.masks, self.replay, self.ties = [], None, 0

    def _side(self, x: torch.Tensor) -> torch.Tensor:
        if self.replay is None:
            self.masks.append(x.detach() > 0)
            return self.masks[-1]
        if self.replay == len(self.masks):
            raise AssertionError("the plain step has more ReLUs than the "
                                 "kernel step")
        m, self.replay = self.masks[self.replay], self.replay + 1
        if m.shape != x.shape:
            raise AssertionError(f"ReLU shapes differ: {tuple(m.shape)} / "
                                 f"{tuple(x.shape)}")
        off = m != (x.detach() > 0)
        if off.any():
            near = float(x.detach()[off].abs().max())
            if near > KINK_TOL * float(x.detach().abs().max()):
                raise AssertionError(f"a ReLU input {near:.3g} lies on "
                                     "another side in the two steps")
            self.ties += int(off.sum())
        return m

    @contextlib.contextmanager
    def patched(self, replay: bool):
        """Within: record (``replay`` False) or replay the sides."""
        relu, leaky = torch.relu, torch.nn.functional.leaky_relu
        self.replay = 0 if replay else None
        torch.relu = lambda x: torch.where(self._side(x), x, 0.0)
        torch.nn.functional.leaky_relu = (
            lambda x, negative_slope=0.01: torch.where(self._side(x), x,
                                                       negative_slope * x))
        try:
            yield
        finally:
            torch.relu, torch.nn.functional.leaky_relu = relu, leaky
        if replay and self.replay != len(self.masks):
            raise AssertionError("the plain step has fewer ReLUs than the "
                                 "kernel step")


def same_step(trainer, batch, seed: int, launches: Launches, per_step,
              what: str, degenerate=(), cancelling=()) -> dict:
    """One kernel step of ``trainer`` against the same step through the plain
    versions, from its warm state (a copy of its model and Adam state), with
    the same batch and dropout masks and on the kernel step's side of every
    ReLU kink (``KinkReplay``): the loss within STEP_LOSS_RTOL, every
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
    result, kinks = {}, KinkReplay()
    for name, t in (("kernel", trainer), ("plain", plain)):
        t.generator.manual_seed(seed)
        launches.zero()
        with kinks.patched(replay=name == "plain"):
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
        f"(rtol {STEP_RTOL}, atol {STEP_ATOL} x max); {kinks.ties} of "
        f"{sum(m.numel() for m in kinks.masks)} ReLU inputs tied to the "
        "kernel step's side of 0" + "".join(f"; {n}" for n in notes))
    return errs


@contextlib.contextmanager
def knob(module, name: str, value: str):
    """Within: ``module.name`` (an opt-in bf16 stream's constant) is
    ``value``."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def opt_in_steps(cfg, graph, banks, launches: Launches, per_step, what: str,
                 seed: int, steps: int, gen, **checks):
    """A model of ``cfg`` made from ``seed`` on ``graph``: ``steps`` timed
    steps (``timed_steps``), then one kernel step against the plain step
    from the warm state (``same_step``, with ``checks``).  Returns the
    timing record and the launches of the timed steps."""
    from kgc_gcn_torch.models import build_model
    from kgc_gcn_torch.train.loop import Trainer
    from kgc_gcn_torch.train.negative import NegativeSamplingTrainer
    device = graph.device
    model = build_model(cfg, graph.n_ent, graph.n_rel, graph.n_edge,
                        e_pad=graph.e_pad,
                        generator=torch.Generator().manual_seed(seed)
                        ).to(device)
    trainer = (NegativeSamplingTrainer
               if cfg.train_mode == "negative_sampling"
               else Trainer)(cfg, model, graph, banks)
    log(f"[opt-in] {what}: {cfg.model} + {cfg.decoder}, d_in "
        f"{cfg.gcn_in_dim}, d_out {cfg.gcn_out_dim}, batch {cfg.batch_size}, "
        f"{cfg.compute_dtype}, use_pallas {cfg.use_pallas}, bwd_perm "
        f"{cfg.bwd_perm}; {sum(p.numel() for p in model.parameters())} "
        "parameters")
    rec = timed_steps(trainer, launches, per_step, what, seed, steps=steps)
    b = cfg.batch_size
    idx = torch.randperm(trainer.n_train, generator=gen)[:b]
    same_step(trainer, trainer.batch(idx.to(device),
                                     torch.ones(b, device=device)),
              seed + 7, launches, per_step, what, **checks)
    return rec, tuple(steps * c for c in per_step)


def bwd_perm_grads(ds, graph, banks, seed: int, gen) -> dict:
    """One MGCN step at the WN18RR preset (use_pallas) under bwd_perm
    contrib, operands and fwdw, from one set of weights with one batch and
    one dropout mask, on the contrib step's side of every ReLU kink: each
    schedule's gradients against contrib's within TOL (rtol, and atol x the
    leaf's largest; the BN directions that BN1 cancels checked finite
    only).  Returns the largest errors."""
    from kgc_gcn_torch.config import dataset_preset
    from kgc_gcn_torch.convert import jax_leaf_names
    from kgc_gcn_torch.models import build_model
    from kgc_gcn_torch.train.loop import Trainer
    cfg = dataset_preset("WN18RR", seed=seed)
    device = graph.device
    b = cfg.batch_size
    idx = torch.randperm(banks["train"].n_queries, generator=gen)[:b]
    grads, kinks = {}, KinkReplay()
    for perm in ("contrib", "operands", "fwdw"):
        cfg_p = cfg.replace(bwd_perm=perm)       # the same weights each time
        model = build_model(cfg_p, ds.num_entity, ds.num_relation,
                            ds.num_edge, e_pad=graph.e_pad,
                            generator=torch.Generator().manual_seed(seed)
                            ).to(device)
        t = Trainer(cfg_p, model, graph, banks)
        t.generator.manual_seed(seed + 11)
        with kinks.patched(replay=perm != "contrib"):
            loss = t.loss(*t.batch(idx.to(device),
                                   torch.ones(b, device=device)))
        grads[perm] = torch.autograd.grad(loss, t.params)
    errs = {}
    for perm in ("operands", "fwdw"):
        errs[perm] = 0.0
        for name, g, want in zip(jax_leaf_names(cfg)[0], grads[perm],
                                 grads["contrib"]):
            if not torch.isfinite(g).all():
                raise AssertionError(f"bwd_perm={perm}: non-finite {name}")
            if name in DEGENERATE:
                continue
            errs[perm] = max(errs[perm], close_rel(
                g, want, TOL, TOL, f"bwd_perm={perm} grad {name}"))
    log(f"[opt-in] one step's gradients under bwd_perm operands / fwdw "
        f"against contrib: max abs err {errs} (rtol {TOL}, atol {TOL} x "
        f"max); {kinks.ties} ReLU inputs tied to contrib's side")
    return errs


def _rss_bytes() -> int:
    """This process's resident set now (Linux)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def bounded_trace(graph, banks, work: str, seed: int) -> dict:
    """``--profile_dir``'s trace at the WN18RR preset's widths: a model
    made from ``seed`` takes TRACE_STEPS + 10 steps untraced (warm), then
    as many under ``utils/profiling.trace``, stepped as the loop steps it.
    The trace must hold TRACE_STEPS steps and the kernels' activity.
    Returns its size, events, seconds with and without it, and the host
    memory that the traced run added."""
    import gzip

    from kgc_gcn_torch.config import dataset_preset
    from kgc_gcn_torch.models import build_model
    from kgc_gcn_torch.train.loop import Trainer
    from kgc_gcn_torch.utils.profiling import TRACE_STEPS, trace
    cfg = dataset_preset("WN18RR", seed=seed)
    model = build_model(cfg, graph.n_ent, graph.n_rel, graph.n_edge,
                        e_pad=graph.e_pad,
                        generator=torch.Generator().manual_seed(seed)
                        ).to(graph.device)
    trainer = Trainer(cfg, model, graph, banks)
    rng = np.random.default_rng(seed)
    n = TRACE_STEPS + 10
    trainer.train_epoch(1, rng, max_steps=3)           # one-time set-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train_epoch(2, rng, max_steps=n)           # host-syncs
    plain_s = time.perf_counter() - t0
    rss0 = _rss_bytes()
    t0 = time.perf_counter()
    with trace(work) as prof:
        trainer.train_epoch(2, rng, max_steps=n, on_step=prof.step)
    traced_s = time.perf_counter() - t0
    rss = _rss_bytes() - rss0
    (name,) = os.listdir(work)
    size = os.path.getsize(os.path.join(work, name))
    with gzip.open(os.path.join(work, name), "rt") as f:
        events = json.load(f)["traceEvents"]
    n = min(n, trainer.steps_per_epoch)
    # the host's step marks (the card's copies are "gpu_user_annotation")
    marks = sum(e.get("name", "").startswith("ProfilerStep#")
                and e.get("cat") == "user_annotation" for e in events)
    kernels = sum(e.get("cat") == "kernel" for e in events)
    # a context that ends inside the bound also marks the step it ends in
    if marks != (TRACE_STEPS if n > TRACE_STEPS else n + 1) or not kernels:
        raise AssertionError(f"bounded trace: {marks} of {n} steps marked "
                             f"(bound {TRACE_STEPS}), {kernels} kernel "
                             "events")
    rec = {"trace_steps": marks, "steps_run": n, "trace_bytes": size,
           "trace_events": len(events), "kernel_events": kernels,
           "seconds_traced": traced_s, "seconds_untraced": plain_s,
           "host_rss_added_bytes": rss}
    log(f"[profile] WN18RR preset ({cfg.model} + {cfg.decoder}), {n} steps "
        f"with trace(), {marks} recorded: {size} B gzip, "
        f"{len(events)} events ({kernels} kernel events), "
        f"{traced_s:.3f} s against {plain_s:.3f} s untraced, host RSS "
        f"+{rss / 2**20:.1f} MiB")
    del trainer, model
    torch.cuda.empty_cache()
    return rec


def toy_profile_run(work: str, seed: int, launches: Launches) -> dict:
    """The CLI on data/Toy at full width with ``--max_epoch 2 --profile_dir
    --ckpt_every 1``: the trace of epoch 2 exists, is not empty and names
    K1's passes; ``periodic.orbax`` loads and equals the run's final
    parameters; epoch 2 has no ``steps_per_s`` in metrics.jsonl; every K1
    launch of the run is counted.  Returns the trace's size and the run's
    launches."""
    import gzip

    from kgc_gcn_torch import cli
    from kgc_gcn_torch.config import Config
    from kgc_gcn_torch.train.checkpoint import PERIODIC_NAME, load_checkpoint
    from kgc_gcn_torch.utils.profiling import TRACE_STEPS
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    prof, exp = os.path.join(work, "profile"), os.path.join(work, "exp")
    final = {}
    train = cli.train_and_evaluate

    def keep(trainer, *a, **k):                # the run's final parameters
        best = train(trainer, *a, **k)
        final.update({n: v.detach().cpu().clone()
                      for n, v in trainer.model.state_dict().items()})
        final["steps"] = trainer.steps_per_epoch
        return best

    cli.train_and_evaluate = keep
    torch.cuda.synchronize()
    launches.zero()                                    # the path starts
    t0 = time.perf_counter()
    try:
        rc = cli.main(["--dataset", "Toy", "--data_dir", data,
                       "--experiments_dir", exp, "--do_train", "--max_epoch",
                       "2", "--seed", str(seed), "--profile_dir", prof,
                       "--ckpt_every", "1"])
    finally:
        cli.train_and_evaluate = train
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = launches.read()                              # the path ends
    steps = final.pop("steps")
    if rc != 0 or got != (8 * steps + 4, 0, 0, 0, 0, 0, 0, 0, 0):
        raise AssertionError(f"toy profile run: rc {rc}, launches {got}")
    (name,) = os.listdir(prof)
    size = os.path.getsize(os.path.join(prof, name))
    with gzip.open(os.path.join(prof, name), "rt") as f:
        events = json.load(f)["traceEvents"]
    k1 = sum("chunk_sums" in e.get("name", "") for e in events)
    if not (name.endswith(".pt.trace.json.gz") and size and k1):
        raise AssertionError(f"toy trace {name}: {size} B, {len(events)} "
                             f"events, {k1} of K1's pass A")
    run = os.path.join(exp, "Toy")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f][1:]
    if [r["epoch"] for r in recs] != [1, 2] or any(
            "steps_per_s" in r for r in recs):
        raise AssertionError(f"toy metrics.jsonl: {recs}")
    cfg = Config.from_json(os.path.join(run, "params.json"))
    sd, _ = load_checkpoint(os.path.join(run, PERIODIC_NAME), cfg)
    for n, v in final.items():
        if not torch.equal(sd[n], v):
            raise AssertionError(f"periodic.orbax {n} is not the final "
                                 "value")
    traced = min(steps, TRACE_STEPS)
    rec = {"trace_bytes": size, "trace_events": len(events),
           "trace_bytes_per_step": size / traced, "steps_per_epoch": steps,
           "steps_traced": traced, "seconds": seconds, "launches": got}
    log(f"[profile] cli Toy --max_epoch 2 --profile_dir --ckpt_every 1: "
        f"{seconds:.2f} s; trace of epoch 2 {name}: {size} B gzip, "
        f"{len(events)} events ({size / traced:.0f} B a step, {traced} of "
        f"{steps} steps traced), "
        f"{k1} events of K1's pass A; periodic.orbax equals the final "
        f"parameters; epoch 2 left out of steps_per_s; launches "
        f"{Launches.show(got)}")
    return rec


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


def check_per_relation(path: str, run_dir: str, ds, graph, banks,
                       logged: dict) -> None:
    """The ``--do_test --per_relation`` file of the checkpoint in
    ``run_dir``: one row per relation whose counts add up to the test
    queries and whose values are the per-relation table of the same
    checkpoint (rounded to 5 digits); the table's count-weighted MRR equals
    the corpus MRR (the tail and head sums over all queries) to 1e-6; the
    test metrics the CLI logged are the table's corpus metrics."""
    from kgc_gcn_torch.config import Config
    from kgc_gcn_torch.models import build_model
    from kgc_gcn_torch.ops.ranking import corpus_from_per_rel
    from kgc_gcn_torch.train.checkpoint import load_checkpoint
    from kgc_gcn_torch.train.loop import _bank_sums, evaluate_per_relation
    with open(path) as f:
        rows = json.load(f)
    cfg = Config.from_json(os.path.join(run_dir, "params.json"))
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge)
    model.load_state_dict(load_checkpoint(run_dir, cfg)[0])
    model = model.to(graph.device).eval()
    per = evaluate_per_relation(cfg, model, graph, banks, "test")
    count = per["count"]
    weighted = float(np.nansum(per["mrr"] * count) / count.sum())
    with torch.no_grad():
        all_ent, all_rel = model.encode(graph)
        sums = [_bank_sums(model, all_ent, all_rel, banks[f"test_{d}"],
                           cfg.batch_size) for d in ("tail", "head")]
    exact = (sums[0]["mrr"] + sums[1]["mrr"]) / (2 * sums[0]["count"])
    n_test = len(ds.test_triples)
    if not (len(rows) == ds.num_relation
            and sum(r["count"] for r in rows) == n_test == int(count.sum())
            and all(r["count"] == int(c) for r, c in zip(rows, count))
            and all((r["mrr"] is None) == (c == 0) for r, c in zip(rows, count))
            and all(abs(r["mrr"] - float(per["mrr"][i])) <= 5e-6 + 1e-9
                    for i, r in enumerate(rows) if r["mrr"] is not None)
            and abs(weighted - exact) <= 1e-6
            and all(abs(logged[k] - v) <= 5e-4 + 1e-9
                    for k, v in corpus_from_per_rel(per).items())):
        raise AssertionError(f"per_relation.json: {len(rows)} rows, counts "
                             f"{[r['count'] for r in rows]} of {n_test}; "
                             f"weighted MRR {weighted} vs {exact}; logged "
                             f"{logged}")
    log(f"[serve] per_relation.json: {len(rows)} relations, counts add up to "
        f"the {n_test} test queries; count-weighted MRR {weighted:.9f} vs "
        f"the corpus MRR {exact:.9f} (|diff| {abs(weighted - exact):.3g}, tol "
        "1e-6); the logged test metrics are the table's")


# ------------------------------------------------------------------- phases

# ------------------------------------------------------------------ phase 14

# a rank that has not ended by then fails the phase (the ranks of one call
# share the card, so a step takes tens to hundreds of ms)
RANK_TIMEOUT_S = 300
# steps of the one-process kernel trainer before the compared step (warm
# Adam state, as same_step's)
WARM_STEPS = 3
# K1's two kernels, and K5's (csrc/segment_sum.cu, csrc/segment_max.cu)
K1_PASSES = ("chunk_sums", "row_fixup")
K5_KERNEL = "segment_max_kernel"
# phase 14 runs dropout off, and without hidden dropout BN2 cancels ConvE's
# fc bias too: its gradient is float noise on both sides
MESH_DEGENERATE = DEGENERATE + ("decoder.fc_b",)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(spec: dict, world: int, work: str, what: str,
                 local_world: int = 0) -> list:
    """Run ``world`` ranks of this script (``--rank``) on ``spec``, all on
    the one card, each with its own timeout; returns each rank's result.
    A rank that fails or outlives RANK_TIMEOUT_S fails the phase; every
    process started here has ended when it returns."""
    here = os.path.dirname(os.path.abspath(__file__))
    spec_path = os.path.join(work, f"spec_{what}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    port, procs, logs = _free_port(), [], []
    t0 = time.perf_counter()
    try:
        for rank in range(world):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), WORLD_SIZE=str(world),
                       RANK=str(rank), LOCAL_RANK=str(rank),
                       LOCAL_WORLD_SIZE=str(local_world or world),
                       OMP_NUM_THREADS="2")
            out = open(os.path.join(work, f"{what}_rank{rank}.out"), "w+")
            err = open(os.path.join(work, f"{what}_rank{rank}.err"), "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank",
                 spec_path], env=env, cwd=here, stdout=out, stderr=err))
        for rank, p in enumerate(procs):
            left = RANK_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                p.wait(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{what}: rank {rank} did not end within "
                                     f"{RANK_TIMEOUT_S} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, (p, (out, err)) in enumerate(zip(procs, logs)):
        out.seek(0)
        err.seek(0)
        lines, tail = out.read().splitlines(), err.read()[-4000:]
        out.close()
        err.close()
        for line in lines:
            if not line.startswith("RANK_RESULT "):
                log(f"  [{what} rank {rank}] {line}")
        if p.returncode != 0:
            raise AssertionError(f"{what}: rank {rank} exited "
                                 f"{p.returncode}:\n{tail}")
        res = [x for x in lines if x.startswith("RANK_RESULT ")]
        if not res:
            raise AssertionError(f"{what}: rank {rank} gave no result")
        results.append(json.loads(res[-1][len("RANK_RESULT "):]))
    log(f"[mesh] {what}: {world} rank(s) in "
        f"{time.perf_counter() - t0:.1f} s")
    return results


def check_collectives(device) -> list:
    """Each collective the paths use, on tensors on ``device`` in the
    default group, against its known result; returns their names."""
    import torch.distributed as dist
    w, r = dist.get_world_size(), dist.get_rank()
    checks = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"collective {what} gave a wrong result")
        checks.append(what)

    for dtype in (torch.float32, torch.float64):
        t = torch.full((5,), float(r + 1), dtype=dtype, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        check(bool((t == w * (w + 1) / 2).all()), f"all_reduce SUM {dtype}")
    t = torch.full((5,), float(r + 1), device=device)
    t[0] = -math.inf
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    check(float(t[1]) == w and float(t[0]) == -math.inf,
          "all_reduce MAX (-inf kept)")
    b = torch.full((3,), 7.0 if r == 0 else float(r), device=device)
    dist.broadcast(b, src=0)
    check(bool((b == 7.0).all()), "broadcast")
    parts = [torch.empty(2, device=device) for _ in range(w)]
    dist.all_gather(parts, torch.full((2,), float(r), device=device))
    check([float(p[0]) for p in parts] == [float(k) for k in range(w)],
          "all_gather")
    if w > 1:   # the entity-sharded schedules' collectives, as they run
        from kgc_gcn_torch.parallel.distributed import (
            ppermute, reduce_scatter_rows)
        grp = dist.new_group(list(range(w)))
        t = torch.arange(2 * w, dtype=torch.float32, device=device) * (r + 1)
        got = reduce_scatter_rows(t[:, None], grp)[:, 0]
        check(got.tolist() == [w * (w + 1) / 2 * k for k in
                               (2 * r, 2 * r + 1)], "reduce_scatter")
        got = ppermute([torch.full((3,), float(r), device=device)], [1],
                       grp)[0]
        check(bool((got == (r - 1) % w).all()), "ppermute")
    return checks


class SlicedReplay(KinkReplay):
    """``KinkReplay`` of the one-process step's ReLU sides in a rank: a
    recorded mask whose leading axis is D (G) times the rank's is cut to
    the rank's data (graph) slice: the decoder's rows of the batch, RGAT's
    edges of a half."""

    def __init__(self, masks, mesh, rows=None):
        super().__init__()
        self.masks, self.mesh, self.rows = list(masks), mesh, rows

    def _side(self, x: torch.Tensor) -> torch.Tensor:
        m = self.masks[self.replay].to(x.device)
        n, mesh, rows = x.shape[0], self.mesh, self.rows
        if (rows is not None and m.shape[0] == rows.n_ent != n
                and n == rows.rows_per):
            # an entity-row mask: this rank's rows, padding rows off
            m = torch.nn.functional.pad(m[rows.lo:rows.lo + rows.n_real],
                                        (0, 0, 0, n - rows.n_real))
        for parts, part in ((mesh.data, mesh.data_rank),
                            (mesh.graph, mesh.graph_rank)):
            if m.shape[0] != n and parts > 1 and m.shape[0] == parts * n:
                m = m[part * n:(part + 1) * n]
                break
        self.masks[self.replay] = m
        return super()._side(x)


def mesh_reference(trainer, seed: int, launches: Launches, per_step,
                   path: str, last: bool, what: str) -> None:
    """The one-process kernel step that the ranks are held against:
    ``trainer`` takes WARM_STEPS steps, then one step on a batch of a
    seeded plan (its first, or with ``last`` its short last one) with its
    ReLU sides recorded; weights, Adam state, batch, sides, loss,
    gradients and updates go to ``path``."""
    import dataclasses as dc

    from kgc_gcn_torch.convert import jax_leaf_names
    from kgc_gcn_torch.data.batching import epoch_batches
    from kgc_gcn_torch.train import optim
    cfg, device = trainer.cfg, trainer.device
    trainer.train_epoch(1, np.random.default_rng(seed),
                        max_steps=WARM_STEPS)
    idx, mask = epoch_batches(trainer.n_train, cfg.batch_size,
                              np.random.default_rng(seed + 1))
    idx, mask = idx[-1 if last else 0], mask[-1 if last else 0]
    cpu = lambda ts: [t.detach().cpu().clone() for t in ts]
    ref = {"cfg": dc.asdict(cfg), "state": {
        k: v.detach().cpu().clone() for k, v in trainer.model.state_dict()
        .items()}, "count": trainer.opt_state.count,
        "mu": cpu(trainer.opt_state.mu), "nu": cpu(trainer.opt_state.nu),
        "idx": torch.from_numpy(idx.astype(np.int64)),
        "mask": torch.from_numpy(mask), "lr": optim.epoch_lr(cfg, 1),
        "names": jax_leaf_names(cfg)[0]}
    batch = trainer.batch(ref["idx"].to(device), ref["mask"].to(device))
    kinks = KinkReplay()
    before = cpu(trainer.params)
    torch.cuda.synchronize()
    launches.zero()
    with kinks.patched(replay=False):
        loss, grads = trainer.gradients(*batch)
    optim.step(trainer.params, grads, trainer.opt_state, cfg, ref["lr"])
    torch.cuda.synchronize()
    got = launches.read()
    if per_step is not None and got != tuple(per_step):
        raise AssertionError(f"{what} reference step: launches "
                             f"{Launches.show(got)}")
    per_step = got
    ref.update(loss=float(loss), grads=cpu(grads), per_step=list(per_step),
               updates=[p.detach().cpu() - b
                        for p, b in zip(trainer.params, before)],
               masks=cpu(kinks.masks))
    torch.save(ref, path)
    log(f"[mesh] {what}: one-process kernel step after {WARM_STEPS} warm "
        f"steps, batch of {int(mask.sum())} rows ({'last' if last else 'first'}"
        f" of the plan): loss {float(loss):.8f}; {Launches.show(got)}")


@contextlib.contextmanager
def recorded_draws(draws: list, replay: bool = False):
    """The edge sampler's draws (``ops/sampler.py:draw_positions``): each
    appended to ``draws`` (on the host), or with ``replay`` taken from it
    in turn, then drawn anew once it is spent."""
    from kgc_gcn_torch.ops import sampler
    draw, queue = sampler.draw_positions, list(draws)

    def record(gen, k, n, device):
        if replay and queue:
            return queue.pop(0).to(device)
        idx = draw(gen, k, n, device)
        if not replay:
            draws.append(idx.detach().cpu())
        return idx

    sampler.draw_positions = record
    try:
        yield
    finally:
        sampler.draw_positions = draw


def rank_step(case: dict, mesh, ds, graph, banks, launches: Launches) -> dict:
    """One rank's share of the compared step (the reference's weights, Adam
    state, batch and ReLU sides), then a profile of three more steps;
    rank 0 holds the loss, every gradient and every update (the per-edge
    tables gathered) against the one-process step as ``same_step`` does."""
    from kgc_gcn_torch.config import Config
    from kgc_gcn_torch.models import build_model
    from kgc_gcn_torch.parallel.distributed import (
        all_gather_cat, flat_all_reduce)
    from kgc_gcn_torch.parallel.mesh import (
        edge_table_names, shard_batches, shard_like)
    from kgc_gcn_torch.train import optim
    from kgc_gcn_torch.train.loop import Trainer
    ref = torch.load(case["ref"])
    cfg = Config(**ref["cfg"]).replace(**case.get("cfg", {}))
    device = mesh.device
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=graph.e_pad, mesh=mesh)
    model.load_state_dict(ref["state"])
    trainer = Trainer(cfg, model.to(device), graph, banks, mesh=mesh,
                      plain=case.get("plain", False))
    trainer.opt_state.count = ref["count"]
    for dst, src in zip(trainer.opt_state.mu + trainer.opt_state.nu,
                        ref["mu"] + ref["nu"]):
        dst.copy_(shard_like(src.to(device), dst, mesh))
    idx, mask = ref["idx"].numpy()[None], ref["mask"].numpy()[None]
    rows = max(float(mask.sum()), 1.0)
    idx, mask = shard_batches(mesh, idx, mask)
    scale = max(float(mask.sum()), 1.0) / rows
    batch = trainer.batch(torch.from_numpy(idx[0]).to(device),
                          torch.from_numpy(mask[0]).to(device))
    before = [p.detach().clone() for p in trainer.params]
    replay = SlicedReplay(ref["masks"], mesh, model.entity_rows)
    torch.cuda.synchronize()
    launches.zero()
    with replay.patched(replay=True):
        loss, grads = trainer.gradients(*batch, scale=scale)
    optim.step(trainer.params, grads, trainer.opt_state, cfg, ref["lr"],
               trainer.sharded, mesh.graph_group)
    torch.cuda.synchronize()
    counts = launches.read()
    want = tuple(case.get("per_step", ref["per_step"]))
    if case.get("per_step") == "boundary":
        # K1 forward and d_x per block of each half's plan
        want = (2 * sum(len(a.blocks)
                        for a in model.entity_sharding.boundary),) + (
            0,) * 8
    if counts != want:
        raise AssertionError(f"{case['name']}: launches "
                             f"{Launches.show(counts)}, want "
                             f"{Launches.show(want)}")
    loss = float(flat_all_reduce([loss], mesh.data_group)[0])
    tables = set(edge_table_names(model))
    whole = lambda t, name: (all_gather_cat(t.detach(), mesh.graph_group, 1)
                             if name in tables else t.detach())
    names = ref["names"]
    got_g = [whole(g, n).cpu() for g, n in zip(grads, names)]
    got_u = [whole(p.detach() - b, n).cpu()
             for p, b, n in zip(trainer.params, before, names)]
    out = {"launches": list(counts), "scale": scale, "ties": replay.ties,
           "edges_a_half": int(trainer.graph.inb.src.shape[0])}
    if mesh.rank == 0:
        out["errs"] = compare_step(case, ref, loss, got_g, got_u, names)
    lr = ref["lr"]
    step = lambda: trainer.train_step(lr, *batch, scale=scale)
    # rank 0's comparison above must not enter the other ranks' times: a
    # collective every rank reaches after it
    torch.distributed.all_reduce(torch.zeros(1, device=device))
    if case.get("profile", True):
        wall, busy, top, _ = profile_kernels(step, steps=3)
        out.update(wall_us=wall, busy_us=busy,
                   k1_us=kinds_us(top, K1_PASSES),
                   k5_us=kinds_us(top, (K5_KERNEL,))[0])
    out["step_ms"] = host_ms(step, case.get("host_steps", 5))
    return out


def compare_step(case: dict, ref: dict, loss: float, got_g, got_u,
                 names) -> dict:
    """``same_step``'s check of one step against another: the loss within
    STEP_LOSS_RTOL, every gradient and update within STEP_RTOL and
    STEP_ATOL x its largest (``cancelling`` leaves: x the step's largest
    gradient, update finite only; ``degenerate`` leaves finite only)."""
    what = case["name"]
    torch.testing.assert_close(torch.tensor(loss), torch.tensor(ref["loss"]),
                               rtol=STEP_LOSS_RTOL, atol=0.0,
                               msg=f"{what}: loss")
    g_max = max(float(g.abs().max()) for g in ref["grads"])
    errs = {"loss": abs(loss - ref["loss"]), "grad": 0.0, "update": 0.0}
    for name, gk, gp, uk, up in zip(names, got_g, ref["grads"], got_u,
                                    ref["updates"]):
        if not (torch.isfinite(gk).all() and torch.isfinite(uk).all()):
            raise AssertionError(f"{what}: non-finite {name}")
        if name in case.get("degenerate", ()):
            continue
        if name.rsplit(".", 1)[-1] in case.get("cancelling", ()):
            torch.testing.assert_close(gk, gp, rtol=STEP_RTOL,
                                       atol=STEP_ATOL * g_max,
                                       msg=f"{what}: grad {name}")
            continue
        errs["grad"] = max(errs["grad"], close_rel(
            gk, gp, STEP_RTOL, STEP_ATOL, f"{what}: grad {name}"))
        errs["update"] = max(errs["update"], close_rel(
            uk, up, STEP_RTOL, STEP_ATOL, f"{what}: update {name}"))
    return errs


def rank_cli(argv, launches: Launches) -> dict:
    """The CLI in this rank's process: its launches, the test metrics it
    logged (rank 0; --do_test), the lines it printed (--do_predict) and
    the checkpoint files it reported writing."""
    from kgc_gcn_torch import cli
    captured, root, out = _Capture(), logging.getLogger(), io.StringIO()
    level = root.level
    root.addHandler(captured)
    if "RANK" in os.environ:   # ranks but 0 keep no log file: INFO on
        root.setLevel(logging.INFO)
    try:
        launches.zero()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            if cli.main(argv) != 0:
                raise AssertionError(f"cli {argv} failed")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        root.removeHandler(captured)
        root.setLevel(level)
    test = [m for m in captured.lines if "Test metrics" in m]
    return {"launches": list(launches.read()), "seconds": seconds,
            "test": test[-1].split("metrics: ")[1].strip() if test else None,
            "stdout": out.getvalue().splitlines(),
            "written": [m for m in captured.lines if "this rank wrote" in m]}


def run_rank(spec_path: str) -> int:
    """One rank of phases 14-16 (``--rank``): join the process group the parent
    configured, check the collectives, then run the spec's steps or CLI."""
    with open(spec_path) as f:
        spec = json.load(f)
    from kgc_gcn_torch.data.batching import make_banks
    from kgc_gcn_torch.data.dataset import load_dataset
    from kgc_gcn_torch.data.graph import build_graph
    from kgc_gcn_torch.ops.basis import basis_backward, basis_segment_sum
    from kgc_gcn_torch.ops.elementwise import bwd_products, compose_msg
    from kgc_gcn_torch.ops.fused_compose import fused_compose
    from kgc_gcn_torch.ops.fused_loss import dense_grads, dense_loss
    from kgc_gcn_torch.ops.segment_max import segment_max
    from kgc_gcn_torch.ops.segment_sum import segment_sum
    from kgc_gcn_torch.parallel import distributed
    from kgc_gcn_torch.parallel.mesh import make_mesh
    from kgc_gcn_torch.utils.cuda_build import load_kernels
    info = distributed.maybe_initialize("cuda")
    load_kernels()
    launches = Launches((segment_sum, dense_loss, dense_grads,
                         basis_segment_sum, basis_backward, segment_max,
                         fused_compose, compose_msg, bwd_products))
    out = {"rank": info.rank, "backend": info.backend,
           "device": str(info.device),
           "collectives": check_collectives(info.device)}
    try:
        if spec["kind"] == "cli":
            out["cli"] = rank_cli(spec["argv"], launches)
            return 0
        mesh = make_mesh(*spec["mesh"], info.device)
        ds = load_dataset(spec["dataset"], spec["data_dir"])
        graph = build_graph(ds.train_triples, ds.num_entity, ds.num_relation)
        banks = make_banks(ds, info.device)
        for case in spec["cases"]:
            with (recorded_draws(torch.load(case["positions"]), replay=True)
                  if "positions" in case else contextlib.nullcontext()):
                out[case["name"]] = rank_step(case, mesh, ds, graph, banks,
                                              launches)
        return 0
    finally:
        print("RANK_RESULT " + json.dumps(out), flush=True)
        distributed.shutdown()


def _same_dataset(a, b, what: str) -> None:
    differ = [f for f in ("entity2id", "relation2id", "num_entity",
                          "num_relation", "num_edge", "train_labels")
              if getattr(a, f) != getattr(b, f)]
    differ += [f for f in ("train_triples", "valid_triples", "test_triples",
                           "train_queries")
               if not np.array_equal(getattr(a, f), getattr(b, f))]
    differ += [k for k, eq in b.eval_queries.items()
               if not (np.array_equal(a.eval_queries[k].triples, eq.triples)
                       and a.eval_queries[k].labels == eq.labels)]
    if differ:
        raise AssertionError(f"{what}: {differ} differ")


def engine_times(root: str, name: str) -> dict:
    """14a: the host data engine on the corpus at ``root``: load and
    ``build_graph`` with the numpy engine and with the C++ one (equal field
    for field), and the C++ locality order; host seconds."""
    import dataclasses as dc

    from kgc_gcn_torch.data.dataset import load_dataset
    from kgc_gcn_torch.data.graph import GraphHalf, build_graph
    from kgc_gcn_torch.data.partition import locality_order
    out, dss, graphs = {}, {}, {}
    for engine, native in (("numpy", False), ("native", True)):
        t0 = time.perf_counter()
        dss[engine] = load_dataset(name, root, use_native=native)
        out[f"load_{engine}_s"] = time.perf_counter() - t0
        d = dss[engine]
        t0 = time.perf_counter()
        graphs[engine] = build_graph(d.train_triples, d.num_entity,
                                     d.num_relation, use_native=native)
        out[f"graph_{engine}_s"] = time.perf_counter() - t0
    _same_dataset(dss["native"], dss["numpy"], "14a engines")
    for half in ("inb", "outb"):
        for f in dc.fields(GraphHalf):
            a, b = (getattr(getattr(graphs[e], half), f.name)
                    for e in ("native", "numpy"))
            if not ((a == b) if f.name == "e_real" else torch.equal(a, b)):
                raise AssertionError(f"14a build_graph {half}.{f.name}")
    d = dss["native"]
    t0 = time.perf_counter()
    order = locality_order(d.train_triples, d.num_entity)
    out["locality_order_native_s"] = time.perf_counter() - t0
    if not np.array_equal(np.sort(order), np.arange(d.num_entity)):
        raise AssertionError("14a: the locality order is no permutation")
    import platform
    cpu = platform.processor() or "model not named"
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as f:
            cpu = next((line.split(":", 1)[1].strip() for line in f
                        if line.startswith("model name")), cpu)
    out["host"] = (f"{platform.machine()} {cpu}, {os.cpu_count()} logical "
                   "CPUs")
    log(f"[engine] {d.num_entity} entities, {d.num_edge} train / "
        f"{len(d.valid_triples)} valid / {len(d.test_triples)} test triples "
        f"on the card's host ({out['host']}): load numpy "
        f"{out['load_numpy_s']:.3f} s, C++ {out['load_native_s']:.3f} s; "
        f"build_graph numpy {out['graph_numpy_s']:.3f} s, C++ "
        f"{out['graph_native_s']:.3f} s; locality order C++ "
        f"{out['locality_order_native_s']:.3f} s; the engines equal field "
        "for field")
    return out


def log_ranks(what: str, results: list, backend: str) -> None:
    """The backend, the collectives and each rank's numbers of each case."""
    for r in results:
        if r["backend"] != backend:
            raise AssertionError(f"{what}: rank {r['rank']} took backend "
                                 f"{r['backend']}, want {backend}")
    log(f"[mesh] {what}: backend {backend} on {results[0]['device']}; "
        f"collectives on CUDA tensors: {', '.join(results[0]['collectives'])}")
    for r in results:
        for name, c in r.items():
            if not isinstance(c, dict) or "launches" not in c:
                continue
            k1 = c["k1_us"]
            log(f"[mesh] {what} {name} rank {r['rank']}: a step launches "
                f"{Launches.show(c['launches'])}; profiled step: K1 "
                f"{us(k1[0])} + {us(k1[1])} µs (passes A + B), K5 "
                f"{us(c['k5_us'])} µs, device busy {c['busy_us']:.1f} of "
                f"{c['wall_us']:.1f} µs wall; host {c['step_ms']:.1f} ms a "
                f"step; {c['ties']} ReLU inputs tied; loss scale "
                f"{c['scale']:.6f}; {c['edges_a_half']} edges a half"
                + (f"; against the one-process step: {c['errs']}"
                   if "errs" in c else ""))


def phase14(seed: int, work: str, corpus_root: str, fb_root: str, ds,
            graph, banks, launches: Launches) -> tuple:
    """14: the host data engine and the edge-partitioned multi-GPU path on
    the one card (ranks share it over gloo); returns (summary, the launches
    of each rank's path)."""
    from kgc_gcn_torch.config import Config, dataset_preset
    from kgc_gcn_torch.models import build_model
    from kgc_gcn_torch.train.checkpoint import load_checkpoint
    from kgc_gcn_torch.train.loop import Trainer
    t14 = time.perf_counter()
    out, paths = {"engine": engine_times(fb_root, "SYN3")}, {}
    no_drop = dict(gcn_drop=0.0, conv_drop=0.0, hidden_drop=0.0,
                   feat_drop=0.0)
    refs = {}
    per_mgcn = (4, 0, 0, 0, 0, 0, 0, 0, 0)
    per_rgat = (10, 0, 0, 0, 0, 2, 0, 0, 0)
    for key, cfg, per, last in (
            ("mgcn", dataset_preset("WN18RR", seed=seed, **no_drop),
             per_mgcn, False),
            ("mgcn_last", dataset_preset("WN18RR", seed=seed, **no_drop),
             per_mgcn, True),
            # K2a / K2b on each data rank's rows: each a mean over its own
            # rows, which the loss scale puts over the global batch's
            ("mgcn_fused", dataset_preset("WN18RR", seed=seed,
                                          loss_impl="fused", **no_drop),
             (4, 1, 1, 0, 0, 0, 0, 0, 0), True),
            ("rgat", dataset_preset("WN18RR", model="rgat",
                                    decoder="distmult", num_heads=4,
                                    seed=seed, **no_drop), per_rgat, False)):
        model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                            e_pad=graph.e_pad, generator=torch.Generator()
                            .manual_seed(seed)).to(graph.device)
        refs[key] = os.path.join(work, f"ref_{key}.pt")
        mesh_reference(Trainer(cfg, model, graph, banks), seed, launches,
                       per, refs[key], last, key)
        del model
        torch.cuda.empty_cache()
    mgcn = {"name": "mgcn", "ref": refs["mgcn"],
            "degenerate": MESH_DEGENERATE}
    steps = lambda mesh, cases: {"kind": "steps", "mesh": mesh,
                                 "dataset": "SYN", "data_dir": corpus_root,
                                 "cases": cases}
    # 14b, 14d: MGCN + ConvE (use_pallas) and RGAT at graph_axis 2
    rgat = {"name": "rgat", "ref": refs["rgat"],
            "cancelling": RGAT_DEGENERATE}
    worlds = {"g2": ([1, 2], [mgcn, rgat]),
              "d2": ([2, 1], [dict(mgcn, ref=refs["mgcn_last"]),
                              dict(mgcn, name="mgcn_fused",
                                   ref=refs["mgcn_fused"])]),
              "d2g2": ([2, 2], [dict(mgcn, ref=refs["mgcn_last"])])}
    for what, (mesh, cases) in worlds.items():
        res = launch_ranks(steps(mesh, cases), mesh[0] * mesh[1], work, what)
        log_ranks(what, res, "gloo")
        out[what] = res
        for r in res:
            for c in cases:
                paths[f"mesh_{what}_{c['name']}_rank{r['rank']}"] = tuple(
                    r[c["name"]]["launches"])
    # 14e: the CLI on two ranks (--graph_axis 2 --partition locality), then
    # --do_test of its checkpoint on the two ranks and in this process
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    run = os.path.join(work, "mesh_cli", "Toy")
    base = ["--dataset", "Toy", "--data_dir", data, "--device", "cuda",
            "--seed", str(seed)]
    train_res = launch_ranks({"kind": "cli", "argv": base + [
        "--experiments_dir", os.path.join(work, "mesh_cli"), "--do_train",
        "--max_epoch", "2", "--graph_axis", "2", "--partition",
        "locality"]}, 2, work, "cli_train")
    test_res = launch_ranks({"kind": "cli", "argv": base + [
        "--experiments_dir", os.path.join(work, "mesh_cli_test"),
        "--do_test", "--restore_dir", run, "--graph_axis", "2"]}, 2, work,
        "cli_test")
    one = rank_cli(base + ["--experiments_dir",
                           os.path.join(work, "one_cli_test"), "--do_test",
                           "--restore_dir", run], launches)
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    best = max(r["val"]["mrr"] for r in recs if "val" in r)
    cfg_t = Config.from_json(os.path.join(run, "params.json"))
    measure = load_checkpoint(run, cfg_t)[1]
    mesh_test = test_res[0]["cli"]["test"]
    if (mesh_test != one["test"] or abs(measure - best) > 1e-6
            or cfg_t.partition != "locality" or len(recs) != 3):
        raise AssertionError(f"14e: two-rank test {mesh_test}, one-process "
                             f"{one['test']}; checkpoint measure {measure} "
                             f"against best val MRR {best}; {recs}")
    for what, res in (("cli_train", train_res), ("cli_test", test_res)):
        for r in res:
            paths[f"mesh_{what}_rank{r['rank']}"] = tuple(
                r["cli"]["launches"])
            if not r["cli"]["launches"][0]:
                raise AssertionError(f"14e {what}: rank {r['rank']} "
                                     "launched no K1")
    paths["mesh_cli_test_one_process"] = tuple(one["launches"])
    log(f"[mesh] cli: two ranks, --graph_axis 2 --partition locality, 2 "
        f"epochs on data/Toy: {train_res[0]['cli']['seconds']:.1f} s, best "
        f"val MRR {best} (= the checkpoint's measure); --do_test on two "
        f"ranks: {mesh_test}; in one process: {one['test']}")
    # 14f: a world of one rank takes NCCL
    res = launch_ranks(steps([1, 1], [dict(mgcn, name="nccl")]), 1, work,
                       "nccl", local_world=1)
    log_ranks("nccl", res, "nccl")
    paths["mesh_nccl_rank0"] = tuple(res[0]["nccl"]["launches"])
    out["refs"] = {k: refs[k] for k in ("mgcn", "rgat")}
    out["seconds"] = time.perf_counter() - t14
    log(f"[phase14] the host data engine and the edge-partitioned path "
        f"{out['seconds']:.1f} s")
    return out, paths


def plan_bytes(graph, g: int, d: int) -> dict:
    """The bytes one rank moves per layer under each entity-sharded
    schedule, at width ``d`` in float32, counted on the host from the
    plans: the forward pass (the backward moves as many, transposed).
    ``gather``: one all_gather of x for both halves and one reduce-scatter
    of both halves side by side; ``ring``: G-1 shifts of the shard and the
    same reduce-scatter; ``boundary``: each half's input and output
    steps, padded as sent (and the real rows)."""
    from kgc_gcn_torch.parallel.boundary import build_boundary_plan
    n_pad = -(-graph.n_ent // g) * g
    rows_per, row = n_pad // g, 4 * d
    scatter = (g - 1) * rows_per * 2 * row
    out = {"gather": (g - 1) * rows_per * row + scatter,
           "ring": (g - 1) * rows_per * row + scatter,
           "boundary": 0, "boundary_real": 0}
    for half in (graph.inb, graph.outb):
        _, st = build_boundary_plan(half.to("cpu"), g, n_pad)
        out["boundary"] += (st["in_rows_padded"] + st["out_rows_padded"]) * row
        out["boundary_real"] += (st["in_rows_real_max"]
                                 + st["out_rows_real_max"]) * row
    return out


def log_es_ranks(what: str, results: list) -> None:
    """Each rank's launches and step time of each phase-15 case."""
    log(f"[entity] {what}: backend {results[0]['backend']} on "
        f"{results[0]['device']}; collectives on CUDA tensors: "
        f"{', '.join(results[0]['collectives'])}")
    for r in results:
        for name, c in r.items():
            if isinstance(c, dict) and "launches" in c:
                log(f"[entity] {what} {name} rank {r['rank']}: a step "
                    f"launches {Launches.show(c['launches'])}; host "
                    f"{c['step_ms']:.1f} ms the next step; "
                    f"{c['ties']} ReLU inputs tied"
                    + (f"; against the one-process step: {c['errs']}"
                       if "errs" in c else ""))


def phase15(seed: int, work: str, corpus_root: str, ds, graph, banks,
            launches: Launches, refs=None) -> tuple:
    """15: the entity-sharded schedules on the one card (ranks share it
    over gloo); returns (summary, the launches of each rank's path).
    ``refs`` are phase 14's one-process reference steps where it ran."""
    from kgc_gcn_torch.config import Config, dataset_preset
    from kgc_gcn_torch.models import build_model
    from kgc_gcn_torch.train.checkpoint import load_checkpoint
    from kgc_gcn_torch.train.loop import Trainer
    t15 = time.perf_counter()
    no_drop = dict(gcn_drop=0.0, conv_drop=0.0, hidden_drop=0.0,
                   feat_drop=0.0)
    cfgs = {"mgcn": dataset_preset("WN18RR", seed=seed, **no_drop),
            "rgcn": dataset_preset("WN18RR", model="rgcn",
                                   decoder="distmult", seed=seed, **no_drop),
            "rgat": dataset_preset("WN18RR", model="rgat",
                                   decoder="distmult", num_heads=4,
                                   seed=seed, **no_drop)}
    refs = dict(refs or {})
    for key, cfg in cfgs.items():
        if key in refs:
            continue
        model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                            e_pad=graph.e_pad, generator=torch.Generator()
                            .manual_seed(seed)).to(graph.device)
        refs[key] = os.path.join(work, f"ref15_{key}.pt")
        mesh_reference(Trainer(cfg, model, graph, banks), seed, launches,
                       None, refs[key], False, f"15 {key}")
        del model
        torch.cuda.empty_cache()
    out, paths = {}, {}
    for g in (2, 4):
        b = plan_bytes(graph, g, cfgs["mgcn"].gcn_in_dim)
        out[f"bytes_g{g}"] = b
        log(f"[entity] bytes a rank moves per layer, forward (the backward "
            f"as many), MGCN at d {cfgs['mgcn'].gcn_in_dim}, graph_axis {g},"
            f" counted from the plans: gather {b['gather']}, ring "
            f"{b['ring']}, boundary {b['boundary']} as sent "
            f"({b['boundary_real']} of real rows)")
    zero, k1 = (0,) * 9, lambda n: (n,) + (0,) * 8

    def case(family, schedule, g, pallas, per_step, tag="", plain=False):
        c = {"name": f"{family}_{schedule}{tag}", "ref": refs[family],
             "per_step": per_step, "host_steps": 1, "profile": False,
             "plain": plain,
             "cfg": {"entity_sharded": schedule, "graph_axis": g,
                     "use_pallas": pallas}}
        if family == "mgcn":
            c["degenerate"] = MESH_DEGENERATE
        if family == "rgat":
            c["cancelling"] = RGAT_DEGENERATE
        return c

    # each kernel form beside its plain form, both against the same
    # one-process step: MGCN's plain schedules (use_pallas off), RGAT's
    # kernel path through the plain versions
    worlds = {
        "es_g2": (2, [case("mgcn", "gather", 2, True, k1(4)),
                      case("mgcn", "gather", 2, False, zero, "_plain"),
                      case("mgcn", "boundary", 2, True, "boundary"),
                      case("mgcn", "boundary", 2, False, zero, "_plain"),
                      case("mgcn", "ring", 2, False, zero),
                      case("rgcn", "gather", 2, False, zero),
                      case("rgcn", "ring", 2, False, zero),
                      case("rgcn", "boundary", 2, False, zero),
                      case("rgat", "gather", 2, True,
                           (10, 0, 0, 0, 0, 2, 0, 0, 0)),
                      case("rgat", "gather", 2, True, zero, "_plain",
                           plain=True)]),
        "es_g4": (4, [case("mgcn", "ring", 4, False, zero),
                      case("mgcn", "boundary", 4, True, "boundary"),
                      case("rgcn", "ring", 4, False, zero),
                      case("rgcn", "boundary", 4, False, zero)])}
    for what, (g, cases) in worlds.items():
        res = launch_ranks({"kind": "steps", "mesh": [1, g], "dataset": "SYN",
                            "data_dir": corpus_root, "cases": cases},
                           g, work, what)
        log_es_ranks(what, res)
        out[what] = res
        for r in res:
            for c in cases:
                paths[f"{what}_{c['name']}_rank{r['rank']}"] = tuple(
                    r[c["name"]]["launches"])
    # the CLI on two ranks under --entity_sharded boundary, then --do_test
    # of its checkpoint on the two ranks and in this process
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    run = os.path.join(work, "es_cli", "Toy")
    base = ["--dataset", "Toy", "--data_dir", data, "--device", "cuda",
            "--seed", str(seed)]
    shard = ["--graph_axis", "2", "--entity_sharded", "boundary",
             "--use_pallas"]
    train_res = launch_ranks({"kind": "cli", "argv": base + shard + [
        "--experiments_dir", os.path.join(work, "es_cli"), "--do_train",
        "--max_epoch", "1", "--partition", "locality"]}, 2, work,
        "es_cli_train")
    test_res = launch_ranks({"kind": "cli", "argv": base + shard + [
        "--experiments_dir", os.path.join(work, "es_cli_test"), "--do_test",
        "--restore_dir", run]}, 2, work, "es_cli_test")
    one = rank_cli(base + ["--experiments_dir",
                           os.path.join(work, "es_one_test"), "--do_test",
                           "--restore_dir", run], launches)
    cfg_t = Config.from_json(os.path.join(run, "params.json"))
    measure = load_checkpoint(run, cfg_t)[1]
    mesh_test = test_res[0]["cli"]["test"]
    if (mesh_test is None or mesh_test != one["test"]
            or cfg_t.entity_sharded != "boundary"):
        raise AssertionError(f"15 cli: two-rank test {mesh_test}, "
                             f"one-process {one['test']}; params.json "
                             f"entity_sharded {cfg_t.entity_sharded}")
    for what, res in (("es_cli_train", train_res), ("es_cli_test", test_res)):
        for r in res:
            paths[f"{what}_rank{r['rank']}"] = tuple(r["cli"]["launches"])
            if not r["cli"]["launches"][0]:
                raise AssertionError(f"15 {what}: rank {r['rank']} launched "
                                     "no K1")
    paths["es_cli_test_one_process"] = tuple(one["launches"])
    log(f"[entity] cli: two ranks, --graph_axis 2 --entity_sharded boundary "
        f"--use_pallas --partition locality, 1 epoch on data/Toy: "
        f"{train_res[0]['cli']['seconds']:.1f} s, checkpoint measure "
        f"{measure}; --do_test on two ranks: {mesh_test}; in one process: "
        f"{one['test']}")
    out["seconds"] = time.perf_counter() - t15
    log(f"[phase15] the entity-sharded schedules {out['seconds']:.1f} s")
    return out, paths


def phase16(seed: int, work: str, corpus_root: str, ds, graph, banks,
            launches: Launches) -> tuple:
    """16: the rest of the edge-partitioned path on the one card (ranks
    share it over gloo); returns (summary, the launches of each rank's
    path)."""
    from kgc_gcn_torch.config import dataset_preset
    from kgc_gcn_torch.models import build_model
    from kgc_gcn_torch.train.loop import Trainer
    t16 = time.perf_counter()
    no_drop = dict(gcn_drop=0.0, conv_drop=0.0, hidden_drop=0.0,
                   feat_drop=0.0)
    k_sample = ds.num_edge // 8
    out, paths, cases = {}, {}, []
    # (a) sampled, K = E/8 a half; (b) the bench's reference schedule: each
    # against the one-process step after WARM_STEPS, the ranks given the
    # compared step's sampled positions
    for key, extra in (("sampled", dict(edge_sample_size=k_sample)),
                       ("reference", dict(agg_schedule="reference"))):
        cfg = dataset_preset("WN18RR", seed=seed, **no_drop, **extra)
        model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                            e_pad=graph.e_pad, generator=torch.Generator()
                            .manual_seed(seed)).to(graph.device)
        ref, draws = os.path.join(work, f"ref16_{key}.pt"), []
        with recorded_draws(draws):
            mesh_reference(Trainer(cfg, model, graph, banks), seed, launches,
                           (0,) * 9, ref, False, f"16 {key}")
        case = {"name": key, "ref": ref, "degenerate": MESH_DEGENERATE,
                "host_steps": 1, "profile": False}
        if draws:   # the compared step's: in-half, then out-half
            case["positions"] = os.path.join(work, "ref16_positions.pt")
            torch.save(draws[-2:], case["positions"])
        cases.append(case)
        del model
        torch.cuda.empty_cache()
    res = launch_ranks({"kind": "steps", "mesh": [1, 2], "dataset": "SYN",
                        "data_dir": corpus_root, "cases": cases}, 2, work,
                       "rest_g2")
    log_es_ranks("rest_g2", res)
    out["steps"] = res
    for r in res:
        for c in cases:
            paths[f"rest_g2_{c['name']}_rank{r['rank']}"] = tuple(
                r[c["name"]]["launches"])
    # (c) the CLI on two ranks: one epoch with periodic checkpoints, each
    # rank writing its chunks; then --do_test --do_predict of last.orbax
    # on the two ranks and in this process
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    run = os.path.join(work, "rest_cli", "Toy")
    base = ["--dataset", "Toy", "--data_dir", data, "--device", "cuda",
            "--seed", str(seed), "--use_pallas"]
    train_res = launch_ranks({"kind": "cli", "argv": base + [
        "--experiments_dir", os.path.join(work, "rest_cli"), "--do_train",
        "--max_epoch", "1", "--graph_axis", "2", "--ckpt_every", "1"]}, 2,
        work, "rest_cli_train")
    tables = ("tree.params.edge_embeddings",
              "tree.opt_state.1.mu.edge_embeddings",
              "tree.opt_state.1.nu.edge_embeddings")
    for r in train_res:
        g = r["rank"]
        own = ", ".join(sorted(f"{t}/0.{g}.0" for t in tables))
        wrote = r["cli"]["written"]
        if (len(wrote) != 2 or not all(w.endswith(f"per-edge chunks: {own}")
                                       for w in wrote)
                or not all(os.path.isdir(os.path.join(run, d))
                           for d in ("last.orbax", "periodic.orbax"))):
            raise AssertionError(f"16c: rank {g} reported {wrote}; "
                                 f"{sorted(os.listdir(run))}")
        log(f"[rest] cli rank {g} wrote: " + "; ".join(
            w.split(": ", 1)[1] for w in wrote))
    with open(os.path.join(work, "rest_queries.txt"), "w") as f:
        with open(os.path.join(data, "Toy", "test.txt")) as t:
            lines = [x.split("\t")[:2] for x in t.read().splitlines()]
        f.write("".join(f"{a}\t{b}\n" for a, b in lines))
    serve = ["--do_test", "--do_predict", "--predict_file",
             os.path.join(work, "rest_queries.txt"), "--top_k", "10",
             "--restore_dir", run]
    mesh_res = launch_ranks({"kind": "cli", "argv": base + serve + [
        "--experiments_dir", os.path.join(work, "rest_cli_serve"),
        "--graph_axis", "2"]}, 2, work, "rest_cli_serve")
    one = rank_cli(base + serve + ["--experiments_dir",
                                   os.path.join(work, "rest_one_serve")],
                   launches)
    two = mesh_res[0]["cli"]
    if (two["test"] is None or two["test"] != one["test"]
            or mesh_res[1]["cli"]["stdout"]
            or not len(two["stdout"]) == len(lines) == len(one["stdout"])):
        raise AssertionError(f"16c: two-rank test {two['test']}, one-process "
                             f"{one['test']}; rank 1 printed "
                             f"{mesh_res[1]['cli']['stdout'][:2]}")
    got = [json.loads(x) for x in two["stdout"]]
    want = [json.loads(x) for x in one["stdout"]]
    names = {}
    table = lambda rows, k: torch.tensor(
        [[e[k] if k == "score" else names.setdefault(e[k], len(names))
          for e in r["topk"]] for r in rows], dtype=torch.float64)
    s_two, s_one = table(got, "score"), table(want, "score")
    assert_topk_match(s_two, table(got, "entity"), s_one,
                      table(want, "entity"), 1e-5)
    for what, rs in (("rest_cli_train", train_res),
                     ("rest_cli_serve", mesh_res)):
        for r in rs:
            paths[f"{what}_rank{r['rank']}"] = tuple(r["cli"]["launches"])
    paths["rest_cli_serve_one_process"] = tuple(one["launches"])
    for r in mesh_res:   # K1 on each half's slice, for the test's encode
        if tuple(r["cli"]["launches"]) != (4,) + (0,) * 8:   # and serving's
            raise AssertionError(f"16c serve rank {r['rank']}: launches "
                                 f"{Launches.show(r['cli']['launches'])}")
    if not all(r["cli"]["launches"][0] for r in train_res):
        raise AssertionError("16c: a training rank launched no K1")
    out["serve_max_score_err"] = float((s_two - s_one).abs().max())
    log(f"[rest] cli: two ranks, --graph_axis 2 --use_pallas --ckpt_every 1,"
        f" 1 epoch on data/Toy: {train_res[0]['cli']['seconds']:.1f} s "
        f"(launches rank 0 {Launches.show(train_res[0]['cli']['launches'])}"
        f"); --do_test --do_predict of last.orbax on two ranks "
        f"{two['seconds']:.1f} s, each rank's encodes K1 4: {two['test']}, "
        f"{len(got)} lines from rank 0, none from rank 1; in one process "
        f"{one['seconds']:.1f} s: {one['test']}; top-10 scores max abs err "
        f"{out['serve_max_score_err']:.3g}")
    out["seconds"] = time.perf_counter() - t16
    log(f"[phase16] the rest of the edge-partitioned path "
        f"{out['seconds']:.1f} s")
    return out, paths


# phase 17's paths: the WN18RR preset's widths on the corpus of phase 5,
# dropout on, with the config's changes, the bf16 stream's knob (or None)
# and the kernels that the recompute must launch (Launches.NAMES)
REMAT_PATHS = {
    "mgcn_halves": (dict(), None, ("K1",)),
    "mgcn_fused": (dict(loss_impl="fused"), None, ("K1",)),
    "mgcn_ew_pallas": (dict(ew_impl="pallas"), None, ("K1", "K4a")),
    "mgcn_stacked": (dict(spmm_mode="stacked"), None, ("K3",)),
    "mgcn_stacked_xla": (dict(spmm_mode="stacked_xla"), None, ("K1",)),
    "mgcn_2layers_corr": (dict(num_layers=2, composition="corr",
                               use_pallas=False), None, ("K1",)),
    "mgcn_sampled": (dict(edge_sample_size=WN18RR[2] // 8), None, ()),
    "mgcn_contrib_bf16": (dict(), ("scatter", "MGCN_CONTRIB"), ("K1",)),
    "rgcn_basis": (dict(model="rgcn", decoder="distmult", num_bases=30),
                   None, ("K7",)),
    "rgcn_block": (dict(model="rgcn", decoder="distmult", num_bases=0,
                        num_blocks=10), None, ("K1",)),
    "rgat": (dict(model="rgat", decoder="distmult", num_heads=4), None,
             ("K1", "K5")),
}
REMAT_SCALES = (1, 4)
REMAT_STEPS = 10


def remat_close(res: dict, cfg, before, what: str) -> None:
    """The remat step within the kernel-vs-plain step's tolerances of the
    plain step (``same_step``'s): the loss, every gradient, update and BN
    statistic; a leaf that BatchNorm cancels (DEGENERATE) or RGAT's
    ``att_dst`` holds its gradient to STEP_ATOL x the step's largest, its
    update finite."""
    from kgc_gcn_torch.convert import jax_leaf_names
    t_p, t_r = res["plain"]["tensors"], res["remat"]["tensors"]
    n = res["plain"]["n_grads"]
    torch.testing.assert_close(t_r[0], t_p[0], rtol=STEP_LOSS_RTOL, atol=0.0,
                               msg=f"{what} loss")
    g_max = max(float(g.abs().max()) for g in t_p[1:1 + n])
    for i, name in enumerate(jax_leaf_names(cfg)[0]):
        g, w = t_r[1 + i], t_p[1 + i]
        u, v = t_r[1 + n + i] - before[i], t_p[1 + n + i] - before[i]
        if name in DEGENERATE or name.rsplit(".", 1)[-1] in RGAT_DEGENERATE:
            torch.testing.assert_close(g, w, rtol=STEP_RTOL,
                                       atol=STEP_ATOL * g_max,
                                       msg=f"{what} grad {name}")
            if not torch.isfinite(u).all():
                raise AssertionError(f"{what}: non-finite update {name}")
            continue
        close_rel(g, w, STEP_RTOL, STEP_ATOL, f"{what} grad {name}")
        close_rel(u, v, STEP_RTOL, STEP_ATOL, f"{what} update {name}")
    for j, (x, y) in enumerate(zip(t_r[1 + 2 * n:], t_p[1 + 2 * n:])):
        close_rel(x, y, STEP_RTOL, STEP_ATOL, f"{what} buffer {j}")


def remat_path(name: str, ds, graph, banks, seed: int, launches: Launches,
               gen) -> dict:
    """One path of ``REMAT_PATHS``: a model from ``seed``, 2 warm steps,
    then from that state the plain step twice and the remat step
    (``tools/remat_probe.py:remat_against_plain``), once with PyTorch's
    default algorithms and once with its deterministic ones: where the
    plain step repeats to the bit the remat step must equal it to the bit,
    elsewhere lie within ``remat_close``; the remat step launches the plain
    step's kernels plus one encoder forward's, among them each kernel of
    the path's recompute."""
    from kgc_gcn_torch.config import dataset_preset
    from kgc_gcn_torch.convert import model_params
    from kgc_gcn_torch.models import build_model
    from kgc_gcn_torch.ops import scatter
    from kgc_gcn_torch.tools.remat_probe import remat_against_plain
    from kgc_gcn_torch.train.loop import Trainer
    extra, knob_at, recomputed = REMAT_PATHS[name]
    cfg = dataset_preset("WN18RR", seed=seed, **extra)
    stream = (knob(scatter, knob_at[1], "bf16") if knob_at
              else contextlib.nullcontext())
    out = {}
    with stream:
        model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                            e_pad=graph.e_pad, generator=torch.Generator()
                            .manual_seed(seed)).to(graph.device)
        if cfg.model == "rgat":        # the attention bias starts at zero
            with torch.no_grad():
                for layer in model.layers:
                    layer.rel_bias.normal_(0.0, 0.5,
                                           generator=torch.Generator(
                                               graph.device).manual_seed(seed))
        warm = Trainer(cfg, model, graph, banks)
        warm.train_epoch(1, np.random.default_rng(seed), max_steps=2)
        b = cfg.batch_size
        idx = torch.randperm(warm.n_train, generator=gen)[:b]
        batch = warm.batch(idx.to(graph.device),
                           torch.ones(b, device=graph.device))
        before = [p.detach().clone() for p in model_params(model, cfg)]
        for mode in ("default", "deterministic"):
            res = remat_against_plain(cfg, model, graph, banks, batch,
                                      launches.wrappers, warm.opt_state,
                                      deterministic=mode == "deterministic")
            if not res["bit_equal"]:
                remat_close(res, cfg, before, f"remat {name} ({mode})")
            out[mode] = res
    got = out["default"]["launches"]
    want = tuple(p + f for p, f in zip(got["plain"], got["forward"]))
    fwd = dict(zip(Launches.NAMES, got["forward"]))
    if (got["remat"] != want or not all(fwd[k] for k in recomputed)
            or out["deterministic"]["launches"] != got):
        raise AssertionError(
            f"remat {name}: launches {Launches.show(got['remat'])}; plain "
            f"{Launches.show(got['plain'])}, encoder forward "
            f"{Launches.show(got['forward'])}, recompute must launch "
            f"{recomputed}")
    rec = {}
    for mode, res in out.items():
        rec[mode] = {k: res[k] for k in ("repeatable", "bit_equal",
                                         "max_abs_err", "plain_spread")}
        kind = ("bit-equal" if res["bit_equal"] else
                f"max abs err {res['max_abs_err']:.3g} (the plain step "
                f"repeats within {res['plain_spread']:.3g})")
        log(f"[remat] {name}, {mode} algorithms: remat step vs plain step "
            f"from one warm state (loss, {res['plain']['n_grads']} "
            f"gradients, parameters, BN statistics, generator state): "
            f"{kind}; the plain step repeats to the bit: "
            f"{res['repeatable']}")
    log(f"[remat] {name}: launches plain {Launches.show(got['plain'])}; "
        f"remat {Launches.show(got['remat'])}")
    rec["launches"] = {k: dict(zip(Launches.NAMES, v)) for k, v in got.items()}
    return rec


def phase17(seed: int, work: str, corpus_root: str, ds, graph, banks,
            launches: Launches, gen) -> tuple:
    """17: ``--remat`` on every path of REMAT_PATHS (remat step against the
    plain step), the memory and time ladder at REMAT_SCALES
    (``tools/remat_probe.py``) and one CLI epoch with ``--remat``; returns
    (summary, the launches of each path's remat step, the ladder's and the
    CLI epoch's)."""
    from kgc_gcn_torch.config import dataset_preset
    from kgc_gcn_torch.tools.remat_probe import probe
    t17 = time.perf_counter()
    out, paths = {"paths": {}, "ladder": []}, {}
    for name in REMAT_PATHS:
        rec = remat_path(name, ds, graph, banks, seed, launches, gen)
        out["paths"][name] = rec
        paths[f"remat_step_{name}"] = tuple(rec["launches"]["remat"].values())
        paths[f"plain_step_{name}"] = tuple(rec["launches"]["plain"].values())
        torch.cuda.empty_cache()
    launches.zero()
    for scale in REMAT_SCALES:
        rec = probe(scale, 1, REMAT_STEPS, graph.device)
        out["ladder"].append(rec)
        log("[remat] ladder " + json.dumps(rec))
    paths["remat_ladder"] = launches.read()
    # one epoch through the CLI with --remat: K1 6 a step (the recompute's
    # 2), 2 in the validation encode
    cfg0 = dataset_preset("WN18RR")
    steps = -(-banks["train"].n_queries // cfg0.batch_size)
    exp_dir = os.path.join(work, "experiments_remat")
    argv = ["--dataset", "SYN", "--data_dir", corpus_root, "--experiments_dir",
            exp_dir, "--do_train", "--remat", "--max_epoch", "1",
            "--eval_every", "1", "--seed", str(seed)]
    for flag in ("learning_rate", "gcn_drop", "feat_drop", "hidden_drop"):
        argv += [f"--{flag}", str(getattr(cfg0, flag))]
    paths["mgcn_remat_train"], ep = cli_epoch(
        argv, os.path.join(exp_dir, "SYN"), launches,
        (6 * steps + 2, 0, 0, 0, 0, 0, 0, 0, 0),
        f"cli --do_train --remat --max_epoch 1 ({steps} steps)")
    out["cli_epoch_s"] = ep["sec"]
    out["seconds"] = time.perf_counter() - t17
    log(f"[remat] phase 17 {out['seconds']:.1f} s")
    return out, paths


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-3 and the K1, K2, K7, K8, K5 and K3 time "
                    "rows only")
    ap.add_argument("--mesh-only", action="store_true",
                    help="phases 1-2 and 14 only (the multi-GPU path)")
    ap.add_argument("--entity-only", action="store_true",
                    help="phases 1-2 and 15 only (the entity-sharded "
                    "schedules, --entity_sharded)")
    ap.add_argument("--rest-only", action="store_true",
                    help="phases 1-2 and 16 only (sampling, the reference "
                    "schedule, checkpoints and serving on ranks)")
    ap.add_argument("--remat-only", action="store_true",
                    help="phases 1-2 and 17 only (--remat)")
    ap.add_argument("--rank", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank:   # one rank of phases 14-16, started by this script
        return run_rank(args.rank)
    t_start = time.perf_counter()

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
        BASIS_SUM_PIECE, basis_backward, basis_backward_reference,
        basis_bwd_window, basis_segment_sum, basis_segment_sum_reference)
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
    from kgc_gcn_torch.utils.torch_import import (
        apply_reference_state_dict, load_reference_checkpoint,
        save_reference_checkpoint)

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
        if ("ptxas info" in line and ("Used" in line or "Compiling" in line)
                or "spill" in line):
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
    if args.mesh_only:
        fb_root = os.path.join(work.name, "fb")
        write_corpus(os.path.join(fb_root, "SYN3"), args.seed, FB15K237)
        phase14(args.seed, work.name, corpus_root, fb_root, ds,
                graph.to(device), make_banks(ds, device), launches)
        work.cleanup()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.entity_only or args.rest_only:
        phase = phase15 if args.entity_only else phase16
        phase(args.seed, work.name, corpus_root, ds, graph.to(device),
              make_banks(ds, device), launches)
        work.cleanup()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.remat_only:
        phase17(args.seed, work.name, corpus_root, ds, graph.to(device),
                make_banks(ds, device), launches, gen)
        work.cleanup()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

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
    # K2b's edges: B above one row chunk of 128, N one past a tile multiple
    # of 64 and below one tile, d 300 (two column windows) and d 1, masked
    # rows; K2a's: d 203 (two windows, 4-byte copies), d 496 (three
    # windows), h and ent one float past a 16-byte boundary (4-byte copies);
    # the FB15k-237 preset's shape is the main path's other width
    k2_shapes = {
        "main": (b_main, ds.num_entity, d_out, ()),
        "fb15k237": (b_main, n_fb, d_out, ()),
        "edge": (5, 1001, 37, (1, 3)),
        "wide": (7, 300, 300, (6,)),
        "b300": (300, 129, 40, (0, 150, 299)),
        "n_below_tile": (9, 50, 64, (4,)),
        "d1": (3, 65, 1, (1,)),
        "d203": (b_main, 700, 203, (3,)),
        "d496": (9, 50, 496, (4,)),
        "misaligned": (70, 333, d_out, (2,)),
    }
    k2_cases = {name: (k2_case(b_, n_, d_, m, gen,
                               offset=int(name == "misaligned")), m)
                for name, (b_, n_, d_, m) in k2_shapes.items()}
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
    # normal values, whose float32 sums depend on their order: K2a and
    # K2b's d_h add the blocks' partials in block order, so two calls give
    # the same bits
    h, ent, bias, w = (torch.randn(b_main, d_out, generator=gen),
                       torch.randn(ds.num_entity, d_out, generator=gen),
                       torch.randn(ds.num_entity, generator=gen),
                       torch.ones(b_main))
    h, ent, bias, w = (t.to(device) for t in (h, ent, bias, w))
    g_t = torch.tensor(1.0 / (b_main * ds.num_entity), device=device)
    first = dense_grads(g_t, h, ent, bias, w, 1.0 / ds.num_entity)
    second = dense_grads(g_t, h, ent, bias, w, 1.0 / ds.num_entity)
    if not all(torch.equal(a, b_) for a, b_ in zip(first, second)):
        raise AssertionError("K2b: two calls on the same inputs differ")
    first = dense_loss(h, ent, bias, w, 1.0 / ds.num_entity)
    if not torch.equal(first, dense_loss(h, ent, bias, w, 1.0 / ds.num_entity)):
        raise AssertionError("K2a: two calls on the same inputs differ")
    log("[K2 check] main shape on normal values: two K2a calls and two K2b "
        "calls bit-identical")
    del h, ent, bias, w, first, second

    # K7 / K8 at BASELINE config 3's shape (FB15k-237 in-half, B 30, d 100),
    # an edge case (empty rows, a hub row, B = 1, d 37) and the power-law
    # graph at config 3's widths
    cfg3 = config3(args.seed)
    nb3, d3 = cfg3.num_bases, cfg3.gcn_in_dim
    hub_dst, hub_ptr = csr(hub)
    fb_in = fb_graph.inb
    # the power-law in-degrees (largest row 40,644 edges, no padding)
    pl_dst, pl_ptr = csr(power_counts)
    # rows above K7's piece length T: two heavy rows meeting inside one
    # piece, rows of exactly T and T + 1 edges, a row of several pieces, a
    # heavy row starting on a piece boundary and a heavy last row ending at E
    t_ = BASIS_SUM_PIECE
    heavy = [100, 2 * t_ + 100, t_ + 150, 3, 0, 2, t_ - 100, t_ + 1,
             5 * t_ + 37, 0, t_, t_ + 40]
    heavy_dst, heavy_ptr = csr(heavy)
    # F1: B 128 at d 256, which the JAX package's kernel trains, does not
    # fit in one K8 block whole: K8 takes d in two windows of 128 columns
    few = torch.randint(0, 4, (200,), generator=gen)
    few[17] = 150                                    # a row over three spans
    few_dst, few_ptr = csr(few)
    basis_shapes = {"config3": (fb_in.dst, fb_in.indptr, n_fb, d3, nb3),
                    "edge": (hub_dst, hub_ptr, hub.shape[0], 37, 1),
                    "heavy_rows": (heavy_dst, heavy_ptr, len(heavy), d3, nb3),
                    "heavy_rows_d200": (heavy_dst, heavy_ptr, len(heavy),
                                        cfg3.gcn_out_dim, nb3),
                    "powerlaw": (pl_dst, pl_ptr, n_fb, d3, nb3),
                    "windows_b128_d256": (few_dst, few_ptr, len(few), 256,
                                          128)}
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
    # normal values on the power-law graph: pass A sums each piece in edge
    # order and pass B the partials in piece order, so two calls give the
    # same bits
    msg, a, dd, ip, _ = basis_case(pl_dst, pl_ptr, n_fb, d3, nb3, gen, True)
    first = basis_segment_sum(msg, a, dd, ip, n_fb)
    if not torch.equal(first, basis_segment_sum(msg, a, dd, ip, n_fb)):
        raise AssertionError("K7: two calls on the same inputs differ")
    log("[K7 check] powerlaw on normal values: two calls bit-identical")
    # F1: the windowed K8 above is one launch a call
    msg, a, dd, ip, g = basis_case(few_dst, few_ptr, len(few), 256, 128, gen,
                                   True)
    before = basis_backward.launches
    basis_backward(g, msg, a, dd, ip)
    if basis_backward.launches != before + 1:
        raise AssertionError("F1: B 128, d 256 did not launch K8 once")
    log(f"[F1 check] K8 at B 128, d 256: windows of "
        f"{basis_bwd_window(256, 128)} columns, one launch a call")
    del msg, a, g, first
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

    fb_logits = torch.randn(fb_graph.inb.dst.shape[0], n_heads, generator=gen)
    fb_logits[fb_graph.inb.norm == 0] = -math.inf
    max_cases = {"wn18rr_h4": (path_logits, graph.inb.dst, graph.inb.indptr,
                               ds.num_entity),
                 # the FB15k-237 in-half and the power-law in-degrees at
                 # FB15k-237's counts (rows of tens of thousands of edges)
                 "fb15k237_h4": (fb_logits, fb_graph.inb.dst,
                                 fb_graph.inb.indptr, n_fb),
                 "powerlaw_h4": (torch.randn(pl_dst.shape[0], n_heads,
                                             generator=gen), pl_dst, pl_ptr,
                                 n_fb)}
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
    # hub rows are combined by whichever piece arrives last; the order of
    # the combination is fixed, so two calls give the same bits
    lg, dd, ip, n_rows = max_cases["powerlaw_h4"]
    first = segment_max(lg, dd, ip, n_rows)
    if not torch.equal(first.view(torch.int32),
                       segment_max(lg, dd, ip, n_rows).view(torch.int32)):
        raise AssertionError("K5: two calls on the same inputs differ")
    log("[K5 check] powerlaw_h4: two calls bit-identical")
    del first

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

    # K3 on the stacked views, the power-law graph and an edge case
    # (k3_cases): dyadic operands first (bit-equal), then normal values
    # (K3_RTOL, K3_ATOL x max); the WN18RR view without its padding edges
    # gives the same bits on dyadic operands and, on normal values, the
    # padded view's plain sums within K3_RTOL / K3_ATOL; two calls on the
    # power-law graph's normal values are bit-identical
    k3_errs = {}
    for real in (False, True):
        k3_real = k3_cases(ds, graph, fb_graph, pl_dst, pl_ptr, hub_dst,
                           hub_ptr, d_in, gen, device, real)
        for name, args_ in k3_real.items():
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
            x_, ip_ = args_[0], args_[7]
            counts = (ip_[1:] - ip_[:-1]).long()
            log(f"[K3 check] {case}: E={args_[5].shape[0]} rows="
                f"{ip_.shape[0] - 1} d={x_.shape[1]} relation rows "
                f"{args_[3].shape[0]} (empty rows {int((counts == 0).sum())}, "
                f"largest row {int(counts.max())} edges): max_abs_err "
                f"{k3_errs[case]:.3g} (tol "
                + (f"rtol {K3_RTOL}, atol {K3_ATOL} x max)" if real
                   else "0: bit-equal)"))
            del got, want
        whole = k3_real["wn18rr_stacked"]
        cut = fused_compose(*without_padding(whole, graph))
        case = f"wn18rr_stacked_{'real' if real else 'dyadic'}_without_padding"
        if real:
            k3_errs[case] = close_rel(cut, fused_compose_reference(*whole),
                                      K3_RTOL, K3_ATOL, f"K3 {case}")
            log(f"[K3 check] {case}: max_abs_err {k3_errs[case]:.3g} against "
                f"the padded view's plain sums (tol rtol {K3_RTOL}, atol "
                f"{K3_ATOL} x max)")
        else:
            if not torch.equal(cut, fused_compose(*whole)):
                raise AssertionError("K3 without the padding edges changed "
                                     "the sums")
            log(f"[K3 check] {case}: the same bits as with them")
        del cut
    first = fused_compose(*k3_real["powerlaw"])
    if not torch.equal(first, fused_compose(*k3_real["powerlaw"])):
        raise AssertionError("K3: two calls on the same inputs differ")
    log("[K3 check] powerlaw on normal values: two calls bit-identical")
    del first, whole

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
        t["pass_a_us"], t["pass_b_us"] = passes_us(
            fns["ms"], ("chunk_sums", "row_fixup"))
        timings[name] = t
        pad = (f"; without the {msg.shape[0] - e_real} padding edges: "
               f"{t['ms_without_padding']:.4f} ms" if e_real is not None else "")
        log(f"[K1 time] {name}: kernel {t['ms']:.4f} ms (passes A / B "
            f"{us(t['pass_a_us'])} / {us(t['pass_b_us'])} µs), plain "
            f"{t['plain_ms']:.4f} ms, index_add_ {t['library_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}); "
            f"{t['bound_ms'] / t['ms']:.1%} of bound{pad}")
    timings["basis_config3"] = time_basis(fb_in, pl_dst, pl_ptr, cfg3, gen)
    for name in ("main", "fb15k237", "edge"):
        timings[f"k2_{name}"] = time_k2(name, *k2_cases[name][0],
                                        profile=name == "main")
    timings["k2a_cases"] = time_k2a_cases(k2_cases)
    timings["k3"] = time_k3(fused_compose, fused_compose_reference, k3_real,
                            graph)
    del k3_real
    torch.cuda.empty_cache()
    timings["k5"] = time_k5(segment_max, segment_max_reference, max_cases,
                            {"wn18rr_h4": graph.inb.e_real,
                             "fb15k237_h4": fb_graph.inb.e_real})
    if args.kernels_only:
        print(json.dumps({"kernels": [k1_entry(errs, timings, {})]
                          + k2_entries(k2_errs, timings, {}, {})
                          + basis_entries(basis_errs, timings["basis_config3"],
                                          {}, {})
                          + [k5_entry(max_errs, timings["k5"], {}),
                             k3_entry(k3_errs, timings["k3"], {})]}))
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
            f"loss_impl={impl} ({trainer.loss_impl})", args.seed,
            kinds=K2A_PASSES if fused else ())
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
    phase6_ent, phase6_metrics = pred.all_ent.clone(), metrics
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
    graph_cli, banks_cli = graph3, banks3
    if cli_root != fb_root:
        graph_cli = build_graph(ds_cli.train_triples, ds_cli.num_entity,
                                ds_cli.num_relation).to(device)
        banks_cli = make_banks(ds_cli, device)
    served_encode(run3, ds_cli, graph_cli, banks_cli, test3[:128], metrics3,
                  "rgcn")
    del graph_cli, banks_cli
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
                                "rgat + distmult, 1-vs-all", args.seed,
                                kinds=("segment_max_kernel",))

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

    # 12. the model surface --------------------------------------------------------
    t12 = time.perf_counter()
    preset_flags = []
    for flag in ("learning_rate", "gcn_drop", "feat_drop", "hidden_drop"):
        preset_flags += [f"--{flag}", str(getattr(cfg0, flag))]

    # 12a. MGCN + ConvE at the WN18RR preset's widths, 2 layers (100 -> 200,
    # 200 -> 200), corr composition, on the corpus of phase 5.  The preset's
    # use_pallas refuses sub and corr in both packages; the CLI's preset
    # yields it, as the JAX CLI's does.  Per layer and half: K1 forward (dst
    # order) and backward d_x (src order); d_rel is an index_add_ below the
    # one-hot limit
    cfg_c = dataset_preset("WN18RR", seed=args.seed, num_layers=2,
                           composition="corr", use_pallas=False)
    model_c = build_model(cfg_c, ds.num_entity, ds.num_relation, ds.num_edge,
                          e_pad=graph.e_pad,
                          generator=torch.Generator().manual_seed(args.seed)
                          ).to(device)
    trainer_c = Trainer(cfg_c, model_c, graph, banks)
    log(f"[surface] mgcn depth: {cfg_c.num_layers} layers "
        f"({cfg_c.gcn_in_dim} -> {cfg_c.gcn_out_dim} -> {cfg_c.gcn_out_dim}),"
        f" composition {cfg_c.composition}, decoder {cfg_c.decoder}, "
        f"loss_impl {cfg_c.loss_impl} = {trainer_c.loss_impl}, batch "
        f"{cfg_c.batch_size}, {cfg_c.compute_dtype}; "
        f"{sum(p.numel() for p in model_c.parameters())} parameters")
    per_c = (8, 0, 0, 0, 0, 0, 0, 0, 0)
    train["mgcn_depth_corr"] = timed_steps(
        trainer_c, launches, per_c, "mgcn 2 layers corr", args.seed)
    paths["mgcn_depth_corr_steps"] = tuple(TIMED_STEPS * c for c in per_c)
    idx = torch.randperm(bank.n_queries, generator=gen)[:cfg_c.batch_size]
    same_step(trainer_c,
              trainer_c.batch(idx.to(device),
                              torch.ones(cfg_c.batch_size, device=device)),
              args.seed + 7, launches, per_c, "mgcn 2 layers corr",
              degenerate=DEGENERATE)
    del trainer_c, model_c
    torch.cuda.empty_cache()
    exp_c = os.path.join(work.name, "experiments_depth")
    run_c = os.path.join(exp_c, "SYN")
    flags_c = ["--num_layers", "2", "--composition", "corr"]
    paths["mgcn_depth_train"], ep = cli_epoch(
        ["--dataset", "SYN", "--data_dir", corpus_root, "--experiments_dir",
         exp_c, "--do_train", "--max_epoch", "1", "--eval_every", "1",
         "--seed", str(args.seed)] + flags_c + preset_flags,
        run_c, launches, (8 * steps_per_epoch + 4, 0, 0, 0, 0, 0, 0, 0, 0),
        f"cli {' '.join(flags_c)} --max_epoch 1 ({steps_per_epoch} steps)")
    train["mgcn_depth_corr"]["cli_epoch_s"] = ep["sec"]
    serve_c = os.path.join(work.name, "serve_depth")
    paths["mgcn_depth_serve"], metrics_c = cli_serve(
        ["--dataset", "SYN", "--data_dir", corpus_root, "--restore_dir", run_c,
         "--experiments_dir", serve_c, "--per_relation"],
        qfile, len(test), ds.entity2id, launches,
        (8, 0, 0, 0, 0, 0, 0, 0, 0), "mgcn depth corr (--per_relation)")
    check_per_relation(os.path.join(serve_c, "SYN", "per_relation.json"),
                       run_c, ds, graph, banks, metrics_c)
    served_encode(run_c, ds, graph, banks, test[:128], metrics_c,
                  "mgcn depth corr")

    # 12b. the decoders at their presets' full widths: MGCN + ComplEx on the
    # fused loss (K2a / K2b), MGCN + TransE and RotatE (no trunk: the dense
    # loss) on the corpus of phase 5; R-GCN config 3 with ComplEx and
    # RotatE on negatives (K = 64) on the corpus of phase 7
    surface_steps = min(10, TIMED_STEPS)
    for name, cfg_d, g_, b_, per_d in (
            ("mgcn + complex, fused",
             dataset_preset("WN18RR", seed=args.seed, decoder="complex",
                            loss_impl="fused"), graph, banks,
             (4, 1, 1, 0, 0, 0, 0, 0, 0)),
            ("mgcn + transe", dataset_preset("WN18RR", seed=args.seed,
                                             decoder="transe"),
             graph, banks, (4, 0, 0, 0, 0, 0, 0, 0, 0)),
            ("mgcn + rotate", dataset_preset("WN18RR", seed=args.seed,
                                             decoder="rotate"),
             graph, banks, (4, 0, 0, 0, 0, 0, 0, 0, 0)),
            ("rgcn + complex, negative sampling",
             cfg3.replace(decoder="complex"), graph3, banks3,
             (2, 0, 0, 2, 2, 0, 0, 0, 0)),
            ("rgcn + rotate, negative sampling",
             cfg3.replace(decoder="rotate"), graph3, banks3,
             (2, 0, 0, 2, 2, 0, 0, 0, 0))):
        n_ent_d = g_.n_ent
        model_d = build_model(cfg_d, n_ent_d, g_.n_rel, g_.n_edge,
                              e_pad=g_.e_pad,
                              generator=torch.Generator().manual_seed(
                                  args.seed)).to(device)
        trainer_d = (NegativeSamplingTrainer
                     if cfg_d.train_mode == "negative_sampling"
                     else Trainer)(cfg_d, model_d, g_, b_)
        loss_d = (cfg_d.neg_loss if cfg_d.train_mode == "negative_sampling"
                  else trainer_d.loss_impl)
        log(f"[surface] {name}: d_in {cfg_d.gcn_in_dim}, d_out "
            f"{cfg_d.gcn_out_dim}, loss {loss_d}, batch "
            f"{cfg_d.batch_size}, {cfg_d.compute_dtype}; "
            f"{sum(p.numel() for p in model_d.parameters())} parameters")
        train[name] = timed_steps(
            trainer_d, launches, per_d, name, args.seed,
            kinds=K2A_PASSES if per_d[1] else (), steps=surface_steps)
        paths[f"{name} steps"] = tuple(surface_steps * c for c in per_d)
        idx = torch.randperm(trainer_d.n_train, generator=gen)[
            :cfg_d.batch_size]
        same_step(trainer_d,
                  trainer_d.batch(idx.to(device),
                                  torch.ones(cfg_d.batch_size, device=device)),
                  args.seed + 7, launches, per_d, name)
        del trainer_d, model_d
        torch.cuda.empty_cache()

    # 12c. BASELINE config 4: MGCN + ConvE at the WN18RR preset on sampled
    # edges, K = E/8 per half (bench.py's sampled mode): the steps launch no
    # kernel (an unsorted index_add_ of the sample); the full-graph
    # evaluation launches K1 once per half
    k_sample = ds.num_edge // 8
    cfg_s4 = dataset_preset("WN18RR", seed=args.seed,
                            edge_sample_size=k_sample)
    model_s4 = build_model(cfg_s4, ds.num_entity, ds.num_relation, ds.num_edge,
                           e_pad=graph.e_pad,
                           generator=torch.Generator().manual_seed(args.seed)
                           ).to(device)
    trainer_s4 = Trainer(cfg_s4, model_s4, graph, banks)
    train["mgcn_sampled"] = timed_steps(
        trainer_s4, launches, (0,) * 9,
        f"mgcn sampled K={k_sample} (E/8) per half", args.seed)
    del trainer_s4, model_s4
    torch.cuda.empty_cache()
    exp_s4 = os.path.join(work.name, "experiments_sampled")
    run_s4 = os.path.join(exp_s4, "SYN")
    flags_s4 = ["--edge_sample_size", str(k_sample)]
    paths["mgcn_sampled_train"], ep = cli_epoch(
        ["--dataset", "SYN", "--data_dir", corpus_root, "--experiments_dir",
         exp_s4, "--do_train", "--max_epoch", "1", "--eval_every", "1",
         "--seed", str(args.seed)] + flags_s4 + preset_flags,
        run_s4, launches, (2, 0, 0, 0, 0, 0, 0, 0, 0),
        f"cli {' '.join(flags_s4)} --max_epoch 1 ({steps_per_epoch} steps)")
    train["mgcn_sampled"]["cli_epoch_s"] = ep["sec"]
    paths["mgcn_sampled_serve"], metrics_s4 = cli_serve(
        ["--dataset", "SYN", "--data_dir", corpus_root, "--restore_dir",
         run_s4, "--experiments_dir", os.path.join(work.name, "serve_sampled")],
        qfile, len(test), ds.entity2id, launches,
        (4, 0, 0, 0, 0, 0, 0, 0, 0), "mgcn sampled")
    served_encode(run_s4, ds, graph, banks, test[:128], metrics_s4,
                  "mgcn sampled")
    phase12_s = time.perf_counter() - t12
    log(f"[surface] phase 12 (model surface) {phase12_s:.1f} s")

    # 13. the last single-device modules ------------------------------------------
    t13 = time.perf_counter()
    from kgc_gcn_torch.ops import basis, scatter, sorted_ops
    opt_steps = min(20, TIMED_STEPS)

    # 13a. bench.py's fb15k_cb: MGCN + ConvE at the FB15k-237 preset's widths
    # with use_pallas, float32 (matmuls, messages, moments) but for the
    # backward's contrib stream, cast to bf16 before its permutation, on the
    # corpus of phase 7; per half K1 forward and K1 backward (d_x)
    cfg_cb = dataset_preset("FB15k-237", seed=args.seed,
                            compute_dtype="float32", moment_dtype="float32")
    per_cb = (4, 0, 0, 0, 0, 0, 0, 0, 0)
    with knob(scatter, "MGCN_CONTRIB", "bf16"):
        train["fb15k_cb"], paths["fb15k_cb_steps"] = opt_in_steps(
            cfg_cb, graph3, banks3, launches, per_cb, "fb15k_cb (mgcn, "
            "KGC_MGCN_CONTRIB=bf16)", args.seed, opt_steps, gen,
            degenerate=DEGENERATE)

    # 13b. bench.py's rgcn_best: config 3 with the backward's readback of
    # d_msg in bf16 (K1 sums the bf16 products in float32)
    per3 = (2, 0, 0, 2, 2, 0, 0, 0, 0)
    with knob(basis, "BASIS_READBACK", "bf16"):
        train["rgcn_best"], paths["rgcn_best_steps"] = opt_in_steps(
            cfg3, graph3, banks3, launches, per3,
            "rgcn_best (config 3, KGC_BASIS_READBACK=bf16)", args.seed,
            opt_steps, gen)

    # 13c. bench.py's rgcn_block: config 3 with 10 block-diagonal relation
    # weights (10 x 10 x 20 blocks); per half K1 forward (dst order) and K1
    # backward (d_x in src order); then a CLI epoch, its checkpoint served
    cfg_blk = cfg3.replace(num_bases=0, num_blocks=10)
    per_blk = (4, 0, 0, 0, 0, 0, 0, 0, 0)
    train["rgcn_block"], paths["rgcn_block_steps"] = opt_in_steps(
        cfg_blk, graph3, banks3, launches, per_blk,
        "rgcn_block (config 3, 10 blocks)", args.seed, opt_steps, gen)
    est_blk_s = (-(-2 * ds3.num_edge // cfg_blk.batch_size)
                 / train["rgcn_block"]["steps_per_s"])
    blk_root, ds_blk = fb_root, ds3
    if est_blk_s > BLOCK_EPOCH_LIMIT_S:
        # both the steps and each step's edge work scale with the triples
        n_cut = int(FB15K237[2] * math.sqrt(BLOCK_EPOCH_LIMIT_S / est_blk_s))
        blk_root = os.path.join(work.name, "fb_block")
        write_corpus(os.path.join(blk_root, "SYN3"), args.seed,
                     (*FB15K237[:2], n_cut, *FB15K237[3:]))
        ds_blk = load_dataset("SYN3", blk_root)
        log(f"[block] rgcn_block CLI epoch cut: {est_blk_s:.1f} s estimated "
            f"at full size > {BLOCK_EPOCH_LIMIT_S} s; {n_cut} train triples")
    exp_blk = os.path.join(work.name, "experiments_block")
    run_blk = os.path.join(exp_blk, "SYN3")
    flags_blk = ["--model", "rgcn", "--decoder", "distmult", "--num_bases",
                 "0", "--num_blocks", "10", "--train_mode",
                 "negative_sampling", "--compute_dtype", "float32",
                 "--moment_dtype", "float32", "--learning_rate",
                 str(cfg3.learning_rate), "--gcn_drop", str(cfg3.gcn_drop)]
    blk_steps = -(-2 * ds_blk.num_edge // cfg_blk.batch_size)
    paths["rgcn_block_train"], ep = cli_epoch(
        ["--dataset", "SYN3", "--data_dir", blk_root, "--experiments_dir",
         exp_blk, "--do_train", "--max_epoch", "1", "--eval_every", "1",
         "--seed", str(args.seed)] + flags_blk,
        run_blk, launches, (4 * blk_steps + 2, 0, 0, 0, 0, 0, 0, 0, 0),
        f"cli --num_blocks 10 --max_epoch 1 ({blk_steps} steps, "
        f"{ds_blk.num_edge} train triples)")
    train["rgcn_block"]["cli_epoch_s"] = ep["sec"]
    id2ent = {i: e for e, i in ds_blk.entity2id.items()}
    id2rel = {i: r for r, i in ds_blk.relation2id.items()}
    test_blk = ds_blk.test_triples[:512]
    qfile_blk = os.path.join(work.name, "queries_block.txt")
    with open(qfile_blk, "w") as f:
        f.write("".join(f"{id2ent[a]}\t{id2rel[b]}\n" for a, b, _ in test_blk))
    paths["rgcn_block_serve"], metrics_blk = cli_serve(
        ["--dataset", "SYN3", "--data_dir", blk_root, "--restore_dir",
         run_blk, "--experiments_dir", os.path.join(work.name, "serve_block")],
        qfile_blk, len(test_blk), ds_blk.entity2id, launches,
        (4, 0, 0, 0, 0, 0, 0, 0, 0), "rgcn_block")
    graph_blk, banks_blk = graph3, banks3
    if blk_root != fb_root:
        graph_blk = build_graph(ds_blk.train_triples, ds_blk.num_entity,
                                ds_blk.num_relation).to(device)
        banks_blk = make_banks(ds_blk, device)
    served_encode(run_blk, ds_blk, graph_blk, banks_blk, test_blk[:128],
                  metrics_blk, "rgcn_block")
    del graph_blk, banks_blk, graph3, banks3
    torch.cuda.empty_cache()

    # 13d. bench.py's rgat_pallas with edge_compose's d_h stream in bf16
    per_a = (10, 0, 0, 0, 0, 2, 0, 0, 0)
    with knob(sorted_ops, "EDGE_CONTRIB", "bf16"):
        train["rgat_edge_bf16"], paths["rgat_edge_bf16_steps"] = opt_in_steps(
            cfg_a, graph, banks, launches, per_a,
            "rgat_pallas (KGC_EDGE_CONTRIB=bf16)", args.seed, opt_steps, gen,
            cancelling=RGAT_DEGENERATE)

    # 13e. MGCN halves at the WN18RR preset (use_pallas) with bwd_perm
    # operands and fwdw, which compute contrib's gradients; one step's
    # gradients of each against contrib's
    per_h = (4, 0, 0, 0, 0, 0, 0, 0, 0)
    for perm in ("operands", "fwdw"):
        cfg_p = dataset_preset("WN18RR", seed=args.seed, bwd_perm=perm)
        train[f"mgcn_{perm}"], paths[f"mgcn_{perm}_steps"] = opt_in_steps(
            cfg_p, graph, banks, launches, per_h, f"mgcn bwd_perm={perm}",
            args.seed, opt_steps, gen, degenerate=DEGENERATE)
    perm_errs = bwd_perm_grads(ds, graph, banks, args.seed, gen)

    # 13f. one CLI run on data/Toy: 2 epochs, epoch 2 traced, a periodic
    # checkpoint every epoch
    toy = toy_profile_run(os.path.join(work.name, "toy"), args.seed, launches)
    paths["toy_profile_train"] = toy.pop("launches")
    # and the trace's bound at the WN18RR preset's widths
    toy["wn18rr_trace"] = bounded_trace(
        graph, banks, os.path.join(work.name, "wn18rr_trace"), args.seed)

    # 13g. --restore_torch: phase 5's weights in the reference's format,
    # read back by the CLI (--do_test, --do_predict) and in process
    cfg5 = Config.from_json(os.path.join(run_dir, "params.json"))
    model = build_model(cfg5, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=graph.e_pad)
    state_dict, best5 = load_checkpoint(run_dir, cfg5)
    model.load_state_dict(state_dict)
    ref_ckpt = os.path.join(work.name, "reference_last.ckpt")
    save_reference_checkpoint(ref_ckpt, model.to(device), graph, best5)
    paths["restore_torch_serve"], metrics_rt = cli_serve(
        ["--dataset", "SYN", "--data_dir", corpus_root, "--restore_torch",
         ref_ckpt, "--experiments_dir", os.path.join(work.name, "serve_rt")],
        qfile, len(test), ds.entity2id, launches,
        (4, 0, 0, 0, 0, 0, 0, 0, 0), "mgcn --restore_torch")
    imported = build_model(cfg5, ds.num_entity, ds.num_relation, ds.num_edge,
                           e_pad=graph.e_pad)
    apply_reference_state_dict(imported, load_reference_checkpoint(
        ref_ckpt, graph)[0])
    imported = imported.to(device).eval()
    with torch.no_grad():
        rt_ent = imported.encode(graph)[0]
    if not torch.equal(rt_ent, phase6_ent):
        raise AssertionError(
            "--restore_torch encode differs from phase 6's: max abs err "
            f"{float((rt_ent - phase6_ent).abs().max()):.3g}")
    check_cli_metrics(metrics_rt, phase6_metrics, ds.num_entity,
                      "--restore_torch")
    log(f"[restore_torch] phase 5's weights through save_reference_checkpoint"
        f" ({os.path.getsize(ref_ckpt)} B) and --restore_torch: encode equal "
        f"to phase 6's to the bit; test metrics {metrics_rt}")
    del model, imported, rt_ent
    torch.cuda.empty_cache()
    phase13_s = time.perf_counter() - t13
    log(f"[phase13] the last single-device modules {phase13_s:.1f} s; "
        f"bwd_perm gradients vs contrib {perm_errs}; toy profile run {toy}")

    # 14. the host data engine and the edge-partitioned multi-GPU path ----------
    mesh_summary, mesh_paths = phase14(args.seed, work.name, corpus_root,
                                       fb_root, ds, graph, banks, launches)
    paths.update(mesh_paths)

    # 15. the entity-sharded schedules -------------------------------------------
    es_summary, es_paths = phase15(args.seed, work.name, corpus_root, ds,
                                   graph, banks, launches,
                                   mesh_summary["refs"])
    paths.update(es_paths)

    # 16. sampling, the reference schedule, checkpoints and serving on ranks
    rest_summary, rest_paths = phase16(args.seed, work.name, corpus_root, ds,
                                       graph, banks, launches)
    paths.update(rest_paths)

    # 17. --remat: the encoder recomputed in the backward ------------------------
    remat_summary, remat_paths = phase17(args.seed, work.name, corpus_root, ds,
                                         graph, banks, launches, gen)
    paths.update(remat_paths)
    work.cleanup()

    paths.update({"mgcn_train": train_launches, "mgcn_serve": serve_launches,
                  "rgcn_train": rgcn_train_launches,
                  "rgcn_serve": rgcn_serve_launches,
                  "rgat_train": rgat_train_launches,
                  "rgat_serve": rgat_serve_launches})
    by_path = lambda i: {k: v[i] for k, v in paths.items()}
    entries = [k1_entry(errs, timings, by_path(0))]
    entries += k2_entries(k2_errs, timings, by_path(1), by_path(2))
    t3 = timings["basis_config3"]
    entries += basis_entries(basis_errs, t3, by_path(3), by_path(4))
    entries.append(k5_entry(max_errs, timings["k5"], by_path(5)))
    entries.append(k3_entry(k3_errs, timings["k3"], by_path(6)))
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
    log(f"[smoke] {torch.cuda.get_device_name(0)}; {smi}; whole script "
        f"{time.perf_counter() - t_start:.1f} s, phase 12 {phase12_s:.1f} s, "
        f"phase 13 {phase13_s:.1f} s, phase 14 {mesh_summary['seconds']:.1f}"
        f" s, phase 15 {es_summary['seconds']:.1f} s, phase 16 "
        f"{rest_summary['seconds']:.1f} s, phase 17 "
        f"{remat_summary['seconds']:.1f} s")
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
