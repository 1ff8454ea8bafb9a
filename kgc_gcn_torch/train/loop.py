"""Evaluation (the eval half of ``kgc_gcn_tpu/train/loop.py``).

The graph is encoded ONCE per evaluation and the decoder scores the query
batches against the cached entity table; ranks are comparison counts
(``ops/ranking.py``).  Training is the next slice of the port.
"""

from __future__ import annotations

import logging
from typing import Dict

import torch

from kgc_gcn_torch.config import Config
from kgc_gcn_torch.data.batching import QueryBank
from kgc_gcn_torch.data.graph import Graph
from kgc_gcn_torch.ops.ranking import combine_head_tail, filtered_ranks, rank_metrics


@torch.no_grad()
def _bank_sums(model, all_ent, all_rel, bank: QueryBank,
               batch_size: int) -> Dict[str, float]:
    sums: Dict[str, float] = {}
    for lo in range(0, bank.n_queries, batch_size):
        q = bank.queries[lo:lo + batch_size]
        logits = model.decode(all_ent, all_rel, q[:, 0], q[:, 1])
        ranks = filtered_ranks(logits, q[:, 2], bank.label_idx[lo:lo + batch_size])
        for k, v in rank_metrics(ranks).items():
            sums[k] = sums.get(k, 0.0) + v
    return sums


@torch.no_grad()
def evaluate(cfg: Config, model, graph: Graph, banks: Dict[str, QueryBank],
             split: str = "valid", mark: str = "Val") -> Dict[str, float]:
    """Filtered MR/MRR/Hits over tail + head queries (reference main.py:80-103)."""
    bs = cfg.eval_batch_size or cfg.batch_size
    all_ent, all_rel = model.encode(graph)
    tail, head = (_bank_sums(model, all_ent, all_rel, banks[f"{split}_{d}"], bs)
                  for d in ("tail", "head"))
    results = combine_head_tail(tail, head)
    log_metrics(mark, results)
    return results


def log_metrics(mark: str, results: Dict[str, float]) -> None:
    """The reference's metric log line (main.py:98-103 format)."""
    logging.info("- %s metrics: %s  ", mark,
                 "; ".join(f"{k}: {v:05.3f}" for k, v in results.items()))
