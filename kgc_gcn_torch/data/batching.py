"""Eval query banks (the eval half of ``kgc_gcn_tpu/data/batching.py``).

Filter labels live on the device as a padded index matrix ``(Q, L_max)``
whose pad value is ``n_ent``; consumers mask the pad column away
(``ops/ranking.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from kgc_gcn_torch.data.dataset import KGDataset, LabelSet


@dataclass(frozen=True)
class QueryBank:
    """Queries + padded filter-label indices for one eval split."""

    queries: torch.Tensor     # int32 (Q, 3) eval (s, r, o)
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
    """Banks for the four eval splits (reference data_loader.py:180-192)."""
    return {key: make_query_bank(eq.triples, eq.labels, ds.num_entity).to(device)
            for key, eq in ds.eval_queries.items()}
