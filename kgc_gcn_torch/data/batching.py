"""Query banks and batching (the port's ``kgc_gcn_tpu/data/batching.py``).

Labels live on the device as a padded index matrix ``(Q, L_max)`` whose pad
value is ``n_ent``; consumers mask the pad entries away (``ops/ranking.py``,
``ops/fused_loss.py``) or drop them (``build_labels``).  The host produces
only the batch order: a shuffled ``(steps, B)`` index plan per epoch, made
with numpy exactly as the JAX package makes it, so one seed gives both
packages the same batches.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from kgc_gcn_torch.data.dataset import KGDataset, LabelSet


@dataclass(frozen=True)
class QueryBank:
    """Queries + padded filter-label indices for one eval split."""

    queries: torch.Tensor     # int32 (Q, 2) train (s, r) | (Q, 3) eval (s, r, o)
    label_idx: torch.Tensor   # int32 (Q, L_max), padded with n_ent
    n_queries: int = 0
    n_ent: int = 0

    def to(self, device) -> "QueryBank":
        return dataclasses.replace(self, queries=self.queries.to(device),
                                   label_idx=self.label_idx.to(device))


def _pad_labels(labels, n_ent: int, width_to: int = 8) -> np.ndarray:
    """Padded (Q, L_max) label-index matrix (pad value n_ent); L_max is
    rounded up to a multiple of ``width_to``."""
    if isinstance(labels, LabelSet):
        lens = np.diff(labels.offsets)
        lmax = int(lens.max()) if len(lens) else 1
        lmax = max(width_to, -(-max(lmax, 1) // width_to) * width_to)
        out = np.full((len(lens), lmax), n_ent, dtype=np.int32)
        rows = np.repeat(np.arange(len(lens)), lens)
        cols = (np.arange(len(labels.values), dtype=np.int64)
                - np.repeat(labels.offsets[:-1], lens))
        out[rows, cols] = labels.values
        return out
    lmax = max((len(l) for l in labels), default=1)
    lmax = max(width_to, -(-lmax // width_to) * width_to)
    out = np.full((len(labels), lmax), n_ent, dtype=np.int32)
    for i, l in enumerate(labels):
        out[i, : len(l)] = l
    return out


def make_query_bank(queries: np.ndarray, labels, n_ent: int) -> QueryBank:
    return QueryBank(
        queries=torch.from_numpy(np.ascontiguousarray(queries, np.int32)),
        label_idx=torch.from_numpy(_pad_labels(labels, n_ent)),
        n_queries=int(len(queries)),
        n_ent=n_ent,
    )


def make_banks(ds: KGDataset, device="cpu") -> Dict[str, QueryBank]:
    """Banks for train + the four eval splits (reference
    data_loader.py:180-192)."""
    banks = {"train": make_query_bank(ds.train_queries, ds.train_labels,
                                      ds.num_entity)}
    for key, eq in ds.eval_queries.items():
        banks[key] = make_query_bank(eq.triples, eq.labels, ds.num_entity)
    return {key: bank.to(device) for key, bank in banks.items()}


def epoch_batches(
    n_queries: int,
    batch_size: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Shuffled, padded batch plan for one epoch: ``idx`` int32 (steps, B)
    indices into the query bank and ``mask`` float32 (steps, B), 0.0 on the
    padding rows of the last batch (reference data_loader.py:186-191:
    shuffle=True, drop_last=False).  Padding rows point at query 0."""
    order = rng.permutation(n_queries)
    steps = -(-n_queries // batch_size)
    total = steps * batch_size
    idx = np.zeros(total, dtype=np.int32)
    idx[:n_queries] = order
    mask = np.zeros(total, dtype=np.float32)
    mask[:n_queries] = 1.0
    return idx.reshape(steps, batch_size), mask.reshape(steps, batch_size)


def build_labels(label_idx: torch.Tensor, n_ent: int,
                 smooth: float = 0.0) -> torch.Tensor:
    """Dense (B, n_ent) float32 multi-hot labels from padded indices, with
    label smoothing ``y = (1 - eps) * y + 1/N`` (reference
    data_loader.py:41-51).  Pad entries equal ``n_ent``: they land in one
    extra column that is cut off."""
    b = label_idx.shape[0]
    y = torch.zeros(b, n_ent + 1, dtype=torch.float32, device=label_idx.device)
    y.scatter_(1, label_idx.long(), 1.0)
    y = y[:, :n_ent]
    if smooth:
        y = (1.0 - smooth) * y + 1.0 / n_ent
    return y
