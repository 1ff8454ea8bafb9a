"""Filtered ranking and link-prediction metrics (the port's
``kgc_gcn_tpu/ops/ranking.py``).

The rank of a known target is a comparison count,

    rank = 1 + #{ e : masked_score[e] > score[obj] },

where every known-true entity is pushed to -inf first (reference
main.py:122-126 filters the same way).  Under exact ties this is the
optimistic rank.  The per-relation sums (``--per_relation``) fold each
query's relation onto its forward id and split the same quantities by it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from kgc_gcn_torch.utils import profiling


def mask_entities(scores: torch.Tensor, filter_idx: torch.Tensor) -> torch.Tensor:
    """Copy of ``scores`` (B, N) with the entities in ``filter_idx`` (B, L)
    set to -inf.  Entries equal to N are padding and are dropped: the scores
    get one extra column for them, cut off again afterwards."""
    b, n = scores.shape
    padded = torch.cat([scores, scores.new_zeros(b, 1)], dim=1)
    padded.scatter_(1, filter_idx.long(), float("-inf"))
    return padded[:, :n]


def filtered_ranks(
    scores: torch.Tensor,       # (B, N) — any monotonic score (logits are fine)
    obj: torch.Tensor,          # (B,) gold entity
    filter_idx: torch.Tensor,   # (B, L) known-true entities, padded with N
) -> torch.Tensor:
    target = scores.gather(1, obj.long()[:, None])
    masked = mask_entities(scores, filter_idx)
    return 1 + (masked > target).sum(dim=1)


def metric_names(hits_at: int = 10) -> List[str]:
    """The keys of ``rank_metrics``, in its order."""
    return ["count", "mr", "mrr"] + [f"hits@{k}" for k in range(1, hits_at + 1)]


def rank_metrics(ranks: torch.Tensor, hits_at: int = 10) -> Dict[str, float]:
    """Sums for one batch (reference main.py:129-133): count, mr, mrr and
    hits@1..hits@{hits_at}, to be combined across the tail and head passes.
    Their read blocks the host on the device (``utils/profiling.py:
    host_reads`` counts it)."""
    r = ranks.double()
    sums = torch.stack([r.sum(), (1.0 / r).sum()]
                       + [(r <= k).sum().double()
                          for k in range(1, hits_at + 1)])
    profiling.host_reads += 1
    return dict(zip(metric_names(hits_at), [float(r.numel())] + sums.tolist()))


def combine_head_tail(
    tail: Dict[str, float], head: Dict[str, float], hits: Sequence[int] = (1, 3, 10)
) -> Dict[str, float]:
    """Average tail- and head-direction sums (reference main.py:84-97)."""
    count = float(tail["count"])
    res = {
        "mr": round((float(tail["mr"]) + float(head["mr"])) / (2 * count), 5),
        "mrr": round((float(tail["mrr"]) + float(head["mrr"])) / (2 * count), 5),
    }
    for k in hits:
        res[f"hits@{k}"] = round(
            (float(tail[f"hits@{k}"]) + float(head[f"hits@{k}"])) / (2 * count), 5)
    return res


def rank_metric_sums_by_rel(ranks: torch.Tensor, rels: torch.Tensor,
                            num_rels: int, hits_at: Sequence[int] = (1, 3, 10)
                            ) -> Dict[str, torch.Tensor]:
    """Per-relation sums (``ranking.py:rank_metric_sums_by_rel``): count,
    mr, mrr and hits@k as (R,) float64 tensors summed over the FORWARD
    relation id ``rel % R``, so the head direction's reverse relations fold
    onto their forward relation."""
    r = ranks.double()
    seg = (rels.long() % num_rels)

    def s(v: torch.Tensor) -> torch.Tensor:
        return torch.zeros(num_rels, dtype=torch.float64,
                           device=v.device).index_add_(0, seg, v)

    out = {"count": s(torch.ones_like(r)), "mr": s(r), "mrr": s(1.0 / r)}
    for k in hits_at:
        out[f"hits@{k}"] = s((r <= k).double())
    return out


def combine_head_tail_by_rel(tail: Dict[str, np.ndarray],
                             head: Dict[str, np.ndarray],
                             hits: Sequence[int] = (1, 3, 10)
                             ) -> Dict[str, np.ndarray]:
    """``combine_head_tail`` per relation (``ranking.py:
    combine_head_tail_by_rel``): the two directions' sums averaged, NaN for
    a relation with no queries."""
    count = np.asarray(tail["count"])
    denom = np.maximum(2.0 * count, 1.0)
    out = {"count": count}
    for k in ("mr", "mrr", *(f"hits@{k}" for k in hits)):
        out[k] = np.where(count > 0,
                          (np.asarray(tail[k]) + np.asarray(head[k])) / denom,
                          np.nan)
    return out


def corpus_from_per_rel(per: Dict[str, np.ndarray],
                        hits: Sequence[int] = (1, 3, 10)) -> Dict[str, float]:
    """The corpus metrics from the per-relation table: their count-weighted
    mean, which is exact (``ranking.py:corpus_from_per_rel``), so that one
    ranking pass gives both reports."""
    c = np.asarray(per["count"], np.float64)
    total = max(float(c.sum()), 1.0)
    out = {}
    for k in ("mr", "mrr", *(f"hits@{h}" for h in hits)):
        v = np.where(c > 0, np.nan_to_num(np.asarray(per[k])), 0.0)
        out[k] = round(float((v * c).sum() / total), 5)
    return out
