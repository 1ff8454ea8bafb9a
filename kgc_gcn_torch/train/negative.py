"""Negative-sampling training (the port's ``kgc_gcn_tpu/train/negative.py``).

The positives are the real edges of both graph halves, ``(src, rel, dst)``:
entries ``[0:E]`` of each dst-sorted half, 2E triples.  Each step scores the
batch's true object against K entities drawn uniformly on the trainer's
device, from the trainer's batch generator (no host RNG, no per-step host
sync; under a data axis, one stream per data row),
through the model's ``score_candidates``.  False negatives are left in, as in
the JAX package.  Objectives (``--neg_loss``): BCE over the 1+K logits,
hinge margin ranking, or RotatE's self-adversarial weighting
(``ops/losses.py``).  Evaluation is the inherited filtered ranking.
"""

from __future__ import annotations

from typing import Dict

import torch

from kgc_gcn_torch.config import Config
from kgc_gcn_torch.data.batching import QueryBank
from kgc_gcn_torch.data.graph import Graph
from kgc_gcn_torch.ops.losses import (
    margin_ranking_loss, sampled_bce_with_logits, self_adversarial_loss)
from kgc_gcn_torch.train.loop import Trainer

NEG_LOSSES = ("bce", "margin", "self_adversarial")


class NegativeSamplingTrainer(Trainer):
    """Trainer whose epoch optimizes a sampled objective over the positive
    triples; ``loss(tri, mask, neg)`` takes the batch's negatives as an
    argument, so a caller can feed chosen ones."""

    def __init__(self, cfg: Config, model, graph: Graph,
                 banks: Dict[str, QueryBank], plain: bool = False,
                 mesh=None):
        if cfg.neg_loss not in NEG_LOSSES:
            raise ValueError(f"unknown neg_loss {cfg.neg_loss!r}; valid: "
                             + " | ".join(NEG_LOSSES))
        super().__init__(cfg, model, graph, banks, plain, mesh)
        e = graph.n_edge   # the whole graph's edges, under a mesh too
        self.pos_triples = torch.cat([
            torch.stack([h.src[:e], h.rel[:e], h.dst[:e]], dim=1)
            for h in (graph.inb, graph.outb)]).long().to(self.device)  # (2E, 3)

    @property
    def n_train(self) -> int:
        return self.pos_triples.shape[0]

    def batch(self, idx: torch.Tensor, mask: torch.Tensor) -> tuple:
        """(triples (B, 3), row mask (B,), negatives (B, K)) of one step."""
        neg = torch.randint(0, self.n_ent, (idx.shape[0], self.cfg.num_negatives),
                            generator=self.batch_generator, device=self.device)
        return self.pos_triples[idx], mask, neg

    def loss(self, tri: torch.Tensor, mask: torch.Tensor,
             neg: torch.Tensor) -> torch.Tensor:
        """The sampled objective of one batch in train mode: the true object
        ``tri[:, 2]`` first, then the negatives ``neg`` (B, K)."""
        cfg, model = self.cfg, self.model
        rngs = self.rngs()
        all_ent, all_rel = model.encode(self.graph, train=True, rngs=rngs,
                                        kernels=self.kernels)
        cand = torch.cat([tri[:, 2:3], neg.to(tri.dtype)], dim=1)   # (B, 1+K)
        logits = model.score_candidates(all_ent, all_rel, tri[:, 0], tri[:, 1],
                                        cand, train=True, rngs=rngs)
        pos, negl = logits[:, 0], logits[:, 1:]
        if cfg.neg_loss == "margin":
            return margin_ranking_loss(pos, negl, cfg.neg_margin, mask)
        if cfg.neg_loss == "self_adversarial":
            return self_adversarial_loss(pos, negl, cfg.neg_margin,
                                         cfg.neg_adversarial_temp, mask)
        return sampled_bce_with_logits(pos, negl, mask)
