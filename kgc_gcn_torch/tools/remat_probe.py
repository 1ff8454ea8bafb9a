"""``--remat`` on the card: the step's peak memory and time with the
encoder's activations kept and recomputed (the port's counterpart of
``scripts/remat_probe.py``), and the check that a remat step is the plain
step.

    python -m kgc_gcn_torch.tools.remat_probe [--layers L ...] [--steps N]
                                              [scale ...]

Defaults: scales 1 4 16, layers 1 and 2, 20 timed steps.  For each scale s
and depth: a graph of WN18RR's proportions (40,943·s entities, 11
relations, 86,835·s random train triples from seed 0), MGCN + ConvE at the
WN18RR preset's widths and dropout (100 → 200, 200 filters 7×7), batch 128,
float32 messages and Adam moments, ``spmm_mode`` halves (K1).  The plain and
the remat trainer run in turns (plain, remat, remat, plain), each from the
same fresh weights: 2 warm steps, then ``steps`` timed ones (CUDA events
around each ``train_step``).  One JSON line a (scale, depth):
  * ``resident_bytes``: allocated before the timed steps (weights, Adam
    state, graph); ``peak_bytes``: ``torch.cuda.max_memory_allocated``
    over them; ``step_bytes`` = peak - resident; ``forward_bytes``: what
    one more forward leaves allocated above resident (the tensors kept for
    its backward), ``forward_peak_bytes`` the most it held above resident
    on the way;
  * ``ms``: each turn's mean ms a step between CUDA events recorded
    before and after it; ``host_ms``: each turn's host ms a step, its
    steps ended by one synchronize;
  * ``saved_bytes``: the bytes of the tensors that autograd keeps for the
    backward in one plain step (weights left out), in the encoder and in
    the rest (decoder and loss), counted through saved-tensor hooks.
The card's name and power limit come first, on a line of their own.  The
module imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from kgc_gcn_torch.config import Config, dataset_preset
from kgc_gcn_torch.data.batching import make_query_bank
from kgc_gcn_torch.data.graph import build_graph
from kgc_gcn_torch.models import build_model
from kgc_gcn_torch.ops.kernels import KERNELS
from kgc_gcn_torch.train import optim
from kgc_gcn_torch.train.loop import Trainer

# WN18RR's counts (entities, relations, train triples) and the batch
WN18RR = (40943, 11, 86835)
BATCH = 128
LR = 1e-3


def probe_config(layers: int, remat: bool) -> Config:
    return dataset_preset("WN18RR", batch_size=BATCH, remat=remat,
                          compute_dtype="float32", moment_dtype="float32",
                          num_layers=layers)


def wn18rr_scaled(scale: int, device):
    """(graph on ``device``, the first BATCH train triples as a query bank,
    train triples) at WN18RR's proportions times ``scale``."""
    n_ent, n_rel, n_edge = WN18RR[0] * scale, WN18RR[1], WN18RR[2] * scale
    rng = np.random.default_rng(0)
    tri = np.stack([rng.integers(n_ent, size=n_edge),
                    rng.integers(n_rel, size=n_edge),
                    rng.integers(n_ent, size=n_edge)], axis=1)
    graph = build_graph(tri, n_ent, n_rel).to(device)
    bank = make_query_bank(tri[:BATCH, :2], [[int(o)] for o in
                                             tri[:BATCH, 2]], n_ent)
    return graph, bank.to(device), n_edge


def new_trainer(cfg: Config, graph, bank, device) -> Trainer:
    model = build_model(cfg, graph.n_ent, graph.n_rel, graph.n_edge,
                        e_pad=graph.e_pad).to(device)
    return Trainer(cfg, model, graph, {"train": bank})


def full_batch(trainer: Trainer) -> tuple:
    b, device = trainer.cfg.batch_size, trainer.device
    return trainer.batch(torch.arange(b, device=device),
                         torch.ones(b, device=device))


def saved_bytes(trainer: Trainer, batch: tuple) -> Dict[str, int]:
    """The bytes autograd keeps for the backward in one forward of the
    plain step, by storage (weights and buffers left out), in the encoder
    and in the rest; nothing is differentiated (the BN statistics move)."""
    own = {t.untyped_storage().data_ptr()
           for t in list(trainer.model.parameters())
           + list(trainer.model.buffers())}
    seen, where = {}, ["rest"]

    def pack(t):
        s = t.untyped_storage()
        if s.data_ptr() not in own and s.data_ptr() not in seen:
            seen[s.data_ptr()] = (where[0], s.nbytes())
        return t.detach()   # a saved output returned whole would keep its
                            # own node alive: a cycle no collector sees

    encode = trainer.encode_train

    def encode_counted(rngs):
        where[0] = "encoder"
        try:
            return encode(rngs)
        finally:
            where[0] = "rest"

    trainer.encode_train = encode_counted
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = trainer.loss(*batch)
    finally:
        del trainer.encode_train
    del loss
    out = {"encoder": 0, "rest": 0}
    for part, n in seen.values():
        out[part] += n
    return out


def timed_run(cfg: Config, graph, bank, steps: int, device) -> dict:
    """A fresh trainer of ``cfg``: 2 warm steps, then ``steps`` timed ones."""
    gc.collect()       # the last run's trainer, were it held in a cycle
    torch.cuda.empty_cache()
    trainer = new_trainer(cfg, graph, bank, device)
    batch = full_batch(trainer)
    for _ in range(2):
        trainer.train_step(LR, *batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    t0 = time.perf_counter()
    for start, end in events:
        start.record()
        trainer.train_step(LR, *batch)
        end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated()
    ms = [s.elapsed_time(e) for s, e in events]
    torch.cuda.reset_peak_memory_stats()
    loss = trainer.loss(*batch)        # one more forward, not differentiated
    torch.cuda.synchronize()
    forward = torch.cuda.memory_allocated() - resident
    forward_peak = torch.cuda.max_memory_allocated() - resident
    del trainer, batch, loss
    gc.collect()
    torch.cuda.empty_cache()
    return {"resident_bytes": resident, "peak_bytes": peak,
            "step_bytes": peak - resident, "forward_bytes": forward,
            "forward_peak_bytes": forward_peak,
            "ms": statistics.mean(ms), "host_ms": host_ms}


def probe(scale: int, layers: int, steps: int = 20,
          device=None) -> dict:
    """One (scale, depth): the plain and the remat step's memory and
    time, in turns, and the plain step's saved bytes."""
    device = device or torch.device("cuda")
    graph, bank, n_edge = wn18rr_scaled(scale, device)
    runs = {False: [], True: []}
    for remat in (False, True, True, False):
        runs[remat].append(timed_run(probe_config(layers, remat), graph,
                                     bank, steps, device))
    trainer = new_trainer(probe_config(layers, False), graph, bank, device)
    saved = saved_bytes(trainer, full_batch(trainer))
    out = {"scale": scale, "layers": layers, "n_ent": graph.n_ent,
           "n_edge": n_edge, "e_pad": graph.e_pad, "batch": BATCH,
           "steps": steps, "saved_bytes": saved}
    del trainer, graph, bank
    gc.collect()
    torch.cuda.empty_cache()
    for remat, name in ((False, "plain"), (True, "remat")):
        a, b = runs[remat]
        out[name] = {**{k: max(a[k], b[k]) for k in
                        ("resident_bytes", "peak_bytes", "step_bytes",
                         "forward_bytes", "forward_peak_bytes")},
                     "ms": [a["ms"], b["ms"]],
                     "host_ms": [a["host_ms"], b["host_ms"]]}
    out["peak_saving_bytes"] = (out["plain"]["peak_bytes"]
                                - out["remat"]["peak_bytes"])
    out["ms_ratio"] = (statistics.mean(out["remat"]["ms"])
                       / statistics.mean(out["plain"]["ms"]))
    return out


# ------------------------------------------------------- remat against plain

def step_outputs(trainer: Trainer, batch: tuple, lr: float,
                 counters: Sequence[Callable]) -> dict:
    """One step by hand (``Trainer.train_step``'s gradients, then Adam):
    the loss, the gradients, the parameters and buffers after it, the
    generator's state, and the launches of ``counters`` (kernel wrappers)
    during it."""
    before = [f.launches for f in counters]
    loss, grads = trainer.gradients(*batch)
    optim.step(trainer.params, grads, trainer.opt_state, trainer.cfg, lr,
               trainer.sharded)
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    return {"tensors": [loss, *grads,
                        *(p.detach().clone() for p in trainer.params),
                        *(b.clone() for b in trainer.model.buffers())],
            "n_grads": len(grads),
            "generator": trainer.generator.get_state(),
            "launches": tuple(f.launches - n
                              for f, n in zip(counters, before))}


@contextlib.contextmanager
def deterministic_algorithms():
    """Within: PyTorch's deterministic algorithms (its index and scatter
    sums and cuDNN's convolution gradients without atomics; a warning where
    an op has none), new memory left unfilled as outside."""
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
        torch.utils.deterministic.fill_uninitialized_memory = fill


def remat_against_plain(cfg: Config, model, graph, banks, batch: tuple,
                        counters: Sequence[Callable] = (),
                        opt_state=None, lr: float = LR,
                        deterministic: bool = False) -> dict:
    """From one state (``model``'s weights and BN statistics, ``opt_state``
    or a fresh Adam state, the generator seeded from ``cfg.seed``): the
    plain step twice and the remat step, each on a copy, with PyTorch's
    default algorithms or its ``deterministic_algorithms``.  Returns whether
    the plain step repeats to the bit (``repeatable``), whether the remat
    step equals it to the bit (``bit_equal``), the largest difference of
    each (``max_abs_err``, ``plain_spread``), each step's launches and the
    encoder forward's (one train-mode encode).  Raises if the generator
    states differ, or if the plain step repeats and the remat step does
    not equal it."""
    runs = []
    mode = (deterministic_algorithms() if deterministic
            else contextlib.nullcontext())
    with mode:
        for remat in (False, False, True):
            trainer = Trainer(cfg.replace(remat=remat), copy.deepcopy(model),
                              graph, banks)
            if opt_state is not None:
                trainer.opt_state = optim.AdamState(
                    opt_state.count, [m.clone() for m in opt_state.mu],
                    [v.clone() for v in opt_state.nu])
            runs.append(step_outputs(trainer, batch, lr, counters))
            del trainer
    enc = copy.deepcopy(model)
    before = [f.launches for f in counters]
    rngs = enc.make_rngs(torch.Generator(device=graph.device).manual_seed(0))
    enc.encode(graph, train=True, rngs=rngs, kernels=KERNELS)
    forward = tuple(f.launches - n for f, n in zip(counters, before))
    del enc
    plain, again, rem = runs
    for other, what in ((again, "plain"), (rem, "remat")):
        if not torch.equal(other["generator"], plain["generator"]):
            raise AssertionError(f"the {what} step left another generator "
                                 "state")

    def diff(a, b):
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        err = max(float((x.float() - y.float()).abs().max()) if x.numel()
                  else 0.0 for x, y in zip(a, b))
        return same, err

    repeatable, spread = diff(again["tensors"], plain["tensors"])
    bit_equal, err = diff(rem["tensors"], plain["tensors"])
    if repeatable and not bit_equal:
        raise AssertionError(f"the plain step repeats to the bit and the "
                             f"remat step differs from it by {err:.3g}")
    return {"repeatable": repeatable, "bit_equal": bit_equal,
            "max_abs_err": err, "plain_spread": spread,
            "plain": plain, "remat": rem,
            "launches": {"plain": plain["launches"],
                         "remat": rem["launches"], "forward": forward}}


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("scales", nargs="*", type=int, default=[1, 4, 16])
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("remat_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    print(f"{card()}; torch {torch.__version__}", flush=True)
    for layers in args.layers:
        for scale in args.scales:
            print(json.dumps(probe(scale, layers, args.steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
