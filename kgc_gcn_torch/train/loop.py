"""Training and evaluation loops (the port's ``kgc_gcn_tpu/train/loop.py``).

  * ``Trainer.train_step``: encode the graph in train mode, score the batch
    through the loss that ``loss_impl`` selects, backpropagate, clip and take
    one Adam step, all on the trainer's device.  ``train_epoch`` drives it
    over the epoch's shuffled batch plan (a Python loop where the JAX package
    runs ``lax.scan``); the padded rows of the last batch are query 0 with
    mask 0 and, as in the JAX package, enter the decoder's BN statistics.
    With ``cfg.remat`` the encoder is recomputed in the backward instead of
    keeping its activations (``train/remat.py``); ``scan_epoch`` is
    accepted and the loop is the same either way (it is ``scan``'s
    counterpart).
  * Evaluation encodes the graph ONCE per pass and scores the query batches
    against the cached entity table; ranks are comparison counts
    (``ops/ranking.py``).  ``evaluate_per_relation`` splits the same ranks
    by forward relation (``--per_relation``).
  * ``train_and_evaluate`` is the reference's epoch loop
    (reference main.py:138-174): eval every ``eval_every`` epochs, best
    validation MRR saved to ``last.ckpt`` (``last.orbax`` on ranks), the
    patience quirk (an improvement smaller than ``patience`` still counts
    as stale), early stop, and one ``metrics.jsonl`` record per epoch.
    With ``profile_dir`` it traces one epoch (``utils/profiling.py``) and
    leaves that epoch out of the timing; with ``cfg.ckpt_every`` it writes
    periodic checkpoints in the background
    (``train/checkpoint.py:AsyncCheckpointer``).

Under a mesh (``parallel/mesh.py``; ``kgc_gcn_tpu/train/loop.py:189-267``)
every rank draws the same epoch plan and takes its data rank's slice of each
step.  Each rank's loss is its rows' numerator over the GLOBAL denominator
(its local loss times ``max(local rows, 1) / max(global rows, 1)``: every
loss divides by ``max(Σ mask, 1)``), so the gradients are summed over the
data group, in one flat collective, not averaged; the epoch's mean loss is
the global one.  The dropout sites of the encoder draw from one stream that
is the same on every rank (its activations are replicated; under
``entity_sharded`` each rank draws the masks of all N rows and keeps its
own), the decoder's sites and the negatives from a stream of the rank's
data row.  Evaluation
ranks each data rank's slice of every batch and sums the metric sums over
the data group; rank 0 alone logs to file and records, and every rank writes
its part of each checkpoint (``train/checkpoint.py``).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from kgc_gcn_torch.config import Config
from kgc_gcn_torch.convert import model_leaf_names, model_params
from kgc_gcn_torch.data.batching import QueryBank, build_labels, epoch_batches
from kgc_gcn_torch.data.graph import Graph
from kgc_gcn_torch.models.common import mm
from kgc_gcn_torch.ops.fused_loss import fused_score_bce, sparse_bce_with_logits
from kgc_gcn_torch.ops.kernels import KERNELS, PLAIN, Kernels
from kgc_gcn_torch.ops.losses import bce_with_logits
from kgc_gcn_torch.ops.ranking import (
    combine_head_tail, combine_head_tail_by_rel, filtered_ranks, metric_names,
    rank_metric_sums_by_rel, rank_metrics)
from kgc_gcn_torch.parallel.distributed import flat_all_reduce
from kgc_gcn_torch.parallel.mesh import (
    Mesh, edge_table_names, shard_batches, shard_graph, shard_params)
from kgc_gcn_torch.train import optim, remat
from kgc_gcn_torch.train.checkpoint import AsyncCheckpointer, save_checkpoint
from kgc_gcn_torch.utils import profiling
from kgc_gcn_torch.utils.profiling import StepTimer, span, trace


class Trainer:
    """Owns the optimizer state and the dropout generator of one (model,
    graph) pair on one device; the generator is seeded from ``cfg.seed``.

    ``plain=True`` runs every kernel's plain PyTorch version instead
    (``ops.kernels.PLAIN``), on any device: the card's check of a kernel
    step against the same step in plain PyTorch.  Either model family
    (``models.build_model``) trains here 1-vs-all; ``train/negative.py``
    trains it on sampled negatives."""

    def __init__(self, cfg: Config, model, graph: Graph,
                 banks: Dict[str, QueryBank], plain: bool = False,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.model = model
        self.mesh = mesh
        if mesh is not None:
            # the model's per-edge tables become this rank's slices, and the
            # (whole) graph this rank's edge slice, on the rank's device;
            # an entity-sharded schedule is built from the whole graph first
            # (kgc_gcn_tpu/train/loop.py:63-74)
            shard_params(model, mesh)
            if cfg.entity_sharded != "none":
                model.prepare_entity_sharding(graph)
            graph = (shard_graph(graph, mesh) if mesh.graph > 1
                     else graph.to(mesh.device))
        self.graph = graph
        self.banks = banks
        self.n_ent = graph.n_ent
        self.device = graph.device
        self.loss_impl = self._resolve_loss_impl(cfg, model)
        self.params = model_params(model, cfg)
        tables = set(edge_table_names(model)) if mesh is not None else set()
        self.sharded = [n in tables for n in model_leaf_names(model, cfg)[0]]
        self.opt_state = optim.init_state(self.params, cfg)
        self.generator = torch.Generator(device=self.device)
        self.batch_generator = self.generator
        if mesh is not None and mesh.data > 1:
            self.batch_generator = torch.Generator(device=self.device)
        self.seed(cfg.seed % 2**32)
        self.kernels = PLAIN if plain else KERNELS

    def seed(self, seed: int) -> None:
        """Seed the encoder's stream (the same on every rank) and the
        stream of the decoder's dropout and the negatives (one per data
        row: ``seed + 1000003 * data rank``)."""
        self.generator.manual_seed(seed)
        if self.batch_generator is not self.generator:
            self.batch_generator.manual_seed(
                (seed + 1000003 * self.mesh.data_rank) % 2**32)

    def rngs(self) -> Dict[str, torch.Generator]:
        """The model's dropout sites of one step, the decoder's (``feat``,
        ``hidden``) on the data row's stream."""
        rngs = self.model.make_rngs(self.generator)
        for site in self.model.DECODER_SITES:
            rngs[site] = self.batch_generator
        return rngs

    @staticmethod
    def _resolve_loss_impl(cfg: Config, model) -> str:
        """``loss.py:88-110``: auto is sparse, as in the JAX package (it
        never materializes the (B, N) label matrix; fused is opt-in); a
        decoder without an ``h @ all_ent.T + bias`` trunk (TransE, RotatE)
        takes the dense loss, with a warning when sparse or fused was asked
        for."""
        impl = "sparse" if cfg.loss_impl == "auto" else cfg.loss_impl
        if impl in ("sparse", "fused") and not model.decoder.has_trunk:
            if cfg.loss_impl != "auto":
                logging.warning(
                    "loss_impl=%s requires a decoder with an "
                    "h @ all_ent.T + bias query trunk; decoder=%s has "
                    "none — falling back to the dense (B, N) loss",
                    cfg.loss_impl, cfg.decoder)
            impl = "dense"
        return impl

    @property
    def n_train(self) -> int:
        """Rows of the epoch's batch plan: the train bank's queries."""
        return self.banks["train"].n_queries

    @property
    def steps_per_epoch(self) -> int:
        return -(-self.n_train // self.cfg.batch_size)

    def batch(self, idx: torch.Tensor, mask: torch.Tensor) -> tuple:
        """The ``loss`` arguments of one step of the batch plan."""
        bank = self.banks["train"]
        return bank.queries[idx], bank.label_idx[idx], mask

    # ------------------------------------------------------------- train step

    def loss(self, q: torch.Tensor, label_idx: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
        """The training loss of one batch, in train mode (dropout, BN batch
        statistics; the BN running statistics move)."""
        cfg, model = self.cfg, self.model
        rngs = self.rngs()
        with span("encode"):
            all_ent, all_rel = self.encode_train(rngs)
        if self.loss_impl in ("sparse", "fused"):
            with span("decode"):
                h, ent_bias = model.query_and_bias(
                    all_ent, all_rel, q[:, 0], q[:, 1], train=True, rngs=rngs)
                if self.loss_impl == "sparse":
                    logits = (mm(h, all_ent.T, cfg.compute_dtype)
                              + ent_bias[None, :])
            with span("loss"):   # the fused loss scores the batch too (K2a)
                if self.loss_impl == "fused":
                    return fused_score_bce(h, all_ent, ent_bias, label_idx,
                                           cfg.lbl_smooth, mask,
                                           self.kernels.dense_loss,
                                           self.kernels.dense_grads)
                return sparse_bce_with_logits(logits, label_idx,
                                              cfg.lbl_smooth, mask)
        with span("decode"):
            logits = model.decode(all_ent, all_rel, q[:, 0], q[:, 1],
                                  train=True, rngs=rngs)
        with span("loss"):
            lbl = build_labels(label_idx, self.n_ent, cfg.lbl_smooth)
            return bce_with_logits(logits, lbl, mask)

    def encode_train(self, rngs: Dict[str, torch.Generator]) -> tuple:
        """The encoder in train mode; with ``cfg.remat`` checkpointed, its
        sites' generators replayed in the recompute (``train/remat.py``)."""
        encode = lambda: self.model.encode(self.graph, train=True, rngs=rngs,
                                           kernels=self.kernels)
        if not self.cfg.remat:
            return encode()
        return remat.checkpointed(
            encode, [g for site, g in rngs.items()
                     if site not in self.model.DECODER_SITES])

    def gradients(self, *batch: torch.Tensor, scale: float = 1.0):
        """(``scale * loss(*batch)``, its gradients in parameter order).
        Under a data axis ``scale`` puts the rank's rows over the global
        batch's, and the gradients are summed over the data group; a
        per-edge table's gradient is the rank's slice."""
        loss = self.loss(*batch)
        if scale != 1.0:
            loss = loss * scale
        with span("backward"):
            grads = list(torch.autograd.grad(loss, self.params))
        if self.mesh is not None:
            with span("allreduce"):
                grads = flat_all_reduce(grads, self.mesh.data_group)
        return loss.detach(), grads

    def train_step(self, lr: float, *batch: torch.Tensor,
                   scale: float = 1.0) -> torch.Tensor:
        """One optimizer step on ``gradients(*batch, scale=scale)``; returns
        the (scaled) batch loss, a device scalar."""
        loss, grads = self.gradients(*batch, scale=scale)
        with span("optimizer"):
            self.kernels.adam(self.params, grads, self.opt_state, self.cfg,
                              lr, self.sharded,
                              self.mesh.graph_group if self.mesh is not None
                              else None)
        return loss

    def train_epoch(self, epoch: int, host_rng: np.random.Generator,
                    max_steps: Optional[int] = None,
                    on_step: Optional[Callable[[], None]] = None) -> float:
        """One epoch over the shuffled batch plan; returns the mean loss.
        ``max_steps`` stops after that many steps; ``on_step`` is called
        after each step (a profiler's ``step``)."""
        cfg = self.cfg
        lr = optim.epoch_lr(cfg, epoch)
        idx, mask = epoch_batches(self.n_train, cfg.batch_size, host_rng)
        scales = np.ones(len(idx))
        if self.mesh is not None and self.mesh.data > 1:
            rows = np.maximum(mask.sum(axis=1), 1.0)
            idx, mask = shard_batches(self.mesh, idx, mask)
            scales = np.maximum(mask.sum(axis=1), 1.0) / rows
        idx = torch.from_numpy(idx).long().to(self.device)
        mask = torch.from_numpy(mask).to(self.device)
        steps = idx.shape[0] if max_steps is None else min(max_steps,
                                                           idx.shape[0])
        losses = []
        for s in range(steps):
            with span("step"):
                losses.append(self.train_step(
                    lr, *self.batch(idx[s], mask[s]), scale=float(scales[s])))
            if on_step is not None:
                on_step()
        profiling.host_reads += 1                      # the one host sync
        if self.mesh is None:
            return float(torch.stack(losses).mean())
        with span("allreduce"):
            total = flat_all_reduce([torch.stack(losses).sum()],
                                    self.mesh.data_group)[0]
        return float(total) / steps

    def evaluate(self, split: str = "valid", mark: str = "Val"
                 ) -> Dict[str, float]:
        return evaluate(self.cfg, self.model, self.graph, self.banks, split,
                        mark, kernels=self.kernels, mesh=self.mesh)

    def evaluate_per_relation(self, split: str = "valid"
                              ) -> Dict[str, np.ndarray]:
        return evaluate_per_relation(self.cfg, self.model, self.graph,
                                     self.banks, split, kernels=self.kernels,
                                     mesh=self.mesh)


# ------------------------------------------------------------------ evaluation

def _bank_ranks(model, all_ent, all_rel, bank: QueryBank, batch_size: int,
                mesh: Optional[Mesh] = None):
    """(queries (b, 3), filtered ranks (b,)) of each query batch of a bank;
    under a data axis, of this data rank's slice of each batch (none where
    the short last batch leaves the slice empty)."""
    parts, part = (1, 0) if mesh is None else (mesh.data, mesh.data_rank)
    width = batch_size // parts
    for lo in range(0, bank.n_queries, batch_size):
        a = lo + part * width
        b = min(a + width, lo + batch_size, bank.n_queries)
        if a >= b:
            continue
        q = bank.queries[a:b]
        with span("score"):
            logits = model.decode(all_ent, all_rel, q[:, 0], q[:, 1])
        with span("rank"):
            ranks = filtered_ranks(logits, q[:, 2], bank.label_idx[a:b])
        yield q, ranks


def _sum_over_data(sums: Dict[str, object], mesh: Optional[Mesh],
                   device) -> Dict[str, object]:
    """Metric sums (floats or (R,) tensors) summed over the data group."""
    if mesh is None or mesh.data == 1:
        return sums
    keys = list(sums)
    with span("allreduce"):
        vals = flat_all_reduce([torch.as_tensor(sums[k], dtype=torch.float64,
                                                device=device) for k in keys],
                               mesh.data_group)
    profiling.host_reads += sum(v.dim() == 0 for v in vals)
    return {k: (float(v) if v.dim() == 0 else v) for k, v in zip(keys, vals)}


@torch.no_grad()
def _bank_sums(model, all_ent, all_rel, bank: QueryBank, batch_size: int,
               mesh: Optional[Mesh] = None) -> Dict[str, float]:
    sums = dict.fromkeys(metric_names(), 0.0)
    for _, ranks in _bank_ranks(model, all_ent, all_rel, bank, batch_size,
                                mesh):
        with span("metric_sync"):
            batch = rank_metrics(ranks)
        for k, v in batch.items():
            sums[k] += v
    return _sum_over_data(sums, mesh, all_ent.device)


@torch.no_grad()
def evaluate(cfg: Config, model, graph: Graph, banks: Dict[str, QueryBank],
             split: str = "valid", mark: str = "Val",
             kernels: Kernels = KERNELS,
             mesh: Optional[Mesh] = None) -> Dict[str, float]:
    """Filtered MR/MRR/Hits over tail + head queries (reference
    main.py:80-103); under a ``mesh``, every rank calls it."""
    bs = cfg.eval_batch_size or cfg.batch_size
    with span("eval_pass"):
        with span("encode"):
            all_ent, all_rel = model.encode(graph, kernels=kernels)
        tail, head = (_bank_sums(model, all_ent, all_rel,
                                 banks[f"{split}_{d}"], bs, mesh)
                      for d in ("tail", "head"))
        results = combine_head_tail(tail, head)
    log_metrics(mark, results)
    return results


@torch.no_grad()
def evaluate_per_relation(cfg: Config, model, graph: Graph,
                          banks: Dict[str, QueryBank], split: str = "valid",
                          kernels: Kernels = KERNELS,
                          mesh: Optional[Mesh] = None
                          ) -> Dict[str, np.ndarray]:
    """Per-relation filtered metrics (``loop.py:evaluate_per_relation``):
    (R,) arrays keyed count/mr/mrr/hits@{1,3,10}, head and tail combined
    onto the forward relation id; NaN for relations with no queries."""
    bs = cfg.eval_batch_size or cfg.batch_size
    with span("eval_pass"):
        with span("encode"):
            all_ent, all_rel = model.encode(graph, kernels=kernels)
        dev = all_ent.device
        empty = torch.zeros(0, dtype=torch.long, device=dev)
        sums = {}
        for d in ("tail", "head"):
            parts = [rank_metric_sums_by_rel(empty, empty, graph.n_rel)] + [
                rank_metric_sums_by_rel(ranks, q[:, 1], graph.n_rel)
                for q, ranks in _bank_ranks(model, all_ent, all_rel,
                                            banks[f"{split}_{d}"], bs, mesh)]
            total = _sum_over_data({k: torch.stack([p[k] for p in parts]).sum(0)
                                    for k in parts[0]}, mesh, dev)
            with span("metric_sync"):
                sums[d] = {k: v.cpu().numpy() for k, v in total.items()}
            profiling.host_reads += len(total)
    return combine_head_tail_by_rel(sums["tail"], sums["head"])


def log_metrics(mark: str, results: Dict[str, float]) -> None:
    """The reference's metric log line (main.py:98-103 format)."""
    logging.info("- %s metrics: %s  ", mark,
                 "; ".join(f"{k}: {v:05.3f}" for k, v in results.items()))


# ------------------------------------------------------------------ epoch loop

def train_and_evaluate(trainer: Trainer, model_dir: Optional[str] = None,
                       saved_best: float = 0.0, seed: int = 0,
                       profile_dir: Optional[str] = None,
                       profile_epoch: int = 2) -> float:
    """Epoch loop with eval-every, best tracking and early stop (reference
    main.py:138-174); returns the best validation MRR.  ``seed`` seeds the
    batch order and the dropout generator.

    With ``profile_dir`` the training of epoch ``profile_epoch`` runs under
    ``torch.profiler`` (one compressed trace of its first
    ``utils/profiling.py:TRACE_STEPS`` steps in ``profile_dir``) and is
    left out of the steps/s, as epoch 1 is (``loop.py:309-383``).  With
    ``cfg.ckpt_every > 0`` and a ``model_dir``, every ``ckpt_every``-th
    epoch writes ``periodic.orbax`` in the background, before validation,
    with the best measure so far; the loop joins the last write when it
    ends, also on an exception."""
    cfg = trainer.cfg
    periodic = (AsyncCheckpointer()
                if cfg.ckpt_every > 0 and model_dir is not None else None)
    try:
        return _epochs(trainer, model_dir, saved_best, seed, profile_dir,
                       profile_epoch, periodic)
    finally:
        if periodic is not None:
            periodic.wait_for_async_checkpoints()


def _epochs(trainer: Trainer, model_dir: Optional[str], saved_best: float,
            seed: int, profile_dir: Optional[str], profile_epoch: int,
            periodic: Optional[AsyncCheckpointer]) -> float:
    cfg, mesh = trainer.cfg, trainer.mesh
    lead = mesh is None or mesh.rank == 0   # the rank that records
    best_measure = saved_best
    patience_counter = 0
    host_rng = np.random.default_rng(seed)
    trainer.generator.manual_seed(seed)
    if mesh is not None:   # and the data rows' streams
        trainer.seed(seed)
    metrics_path = (os.path.join(model_dir, "metrics.jsonl")
                    if model_dir is not None and lead else None)
    if not lead:
        profile_dir = None

    def record(rec):
        """One JSON line per epoch in <model_dir>/metrics.jsonl."""
        if metrics_path is not None:
            with open(metrics_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    # the file appends across runs in one model_dir: consumers split runs here
    record({"run_start": True, "dataset": cfg.dataset,
            "max_epoch": cfg.max_epoch, "seed": seed,
            "restored_best": saved_best})
    steps = trainer.steps_per_epoch
    timer = StepTimer(trainer.graph.num_messages)

    logging.info("Starting training for %d epoch(s)", cfg.max_epoch)
    for epoch in range(1, cfg.max_epoch + 1):
        profiled = bool(profile_dir) and epoch == profile_epoch
        t0 = time.perf_counter()
        if profiled:
            with trace(profile_dir) as prof:
                loss = trainer.train_epoch(epoch, host_rng, on_step=prof.step)
            logging.info("Captured device trace of epoch %d -> %s", epoch,
                         profile_dir)
        else:
            loss = trainer.train_epoch(epoch, host_rng)
        dt = time.perf_counter() - t0    # train only (train_epoch host-syncs)
        rec = {"epoch": epoch, "loss": round(loss, 6),
               "lr": optim.epoch_lr(cfg, epoch), "sec": round(dt, 3)}
        # epoch 1 carries one-time set-up; a traced epoch, the profiler's
        if epoch > 1 and not profiled:
            timer.add(dt, steps)
            rec["steps_per_s"] = round(steps / dt, 2)
        rate = (f", {timer.steps_per_s:.2f} steps/s, "
                f"{timer.edges_per_s_per_chip:.3e} edges/s"
                if timer.steps else "")
        logging.info("Epoch %d/%d  loss=%07.5f  (%.2fs%s)",
                     epoch, cfg.max_epoch, loss, dt, rate)

        if periodic is not None and epoch % cfg.ckpt_every == 0:
            # crash insurance on a fixed cadence, beside the best checkpoint
            periodic.save_checkpoint_async(model_dir, trainer.model,
                                           trainer.opt_state, cfg,
                                           best_measure)

        if epoch % cfg.eval_every == 0:
            val = trainer.evaluate("valid", mark="Val")
            rec["val"] = val
            improve = val["mrr"] - best_measure
            if improve > 0:
                best_measure = val["mrr"]
                if model_dir is not None:
                    save_checkpoint(model_dir, trainer.model,
                                    trainer.opt_state, cfg, best_measure)
                if improve < cfg.patience:
                    patience_counter += 1
                else:
                    patience_counter = 0
            else:
                patience_counter += 1
            rec["best_mrr"] = round(best_measure, 6)

            if (cfg.patience_num > 0 and patience_counter >= cfg.patience_num
                    and epoch > cfg.min_epoch):
                logging.info("Early stopping with best val measure: %05.3f",
                             best_measure)
                record(rec)
                break
        record(rec)
    return best_measure
