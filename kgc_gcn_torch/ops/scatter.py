"""Relational message aggregation (the ``mult`` composition of
``kgc_gcn_tpu/ops/scatter.py`` and the forward of
``kgc_gcn_tpu/ops/spmm_pallas.py:_aggregate_cvjp``).

Per edge the message is ``x[src] * rel_all[rel] * etab`` scaled by the degree
norm; the dense projection comes after aggregation (``(Σ m) @ W == Σ (m @ W)``),
so the segment-sum runs in ``d_in`` and the projection is one (N, d_in) matmul.
Self-loop messages need no scatter: their aggregation is a dense product.
"""

from __future__ import annotations

import torch

from kgc_gcn_torch.data.graph import GraphHalf
from kgc_gcn_torch.ops.segment_sum import segment_sum

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compose_messages(
    x: torch.Tensor,          # (N, d_in) entity embeddings
    rel_all: torch.Tensor,    # (2R + 1, d_in) relation embeddings (+ loop row)
    etab: torch.Tensor,       # (E_pad, d_in) THIS half's per-edge embeddings,
                              #   row k belongs to edge position k
    half: GraphHalf,
) -> torch.Tensor:
    """Per-edge composed message ``(x[src] * rel[rel] * etab) * norm``, in the
    order of ``spmm_pallas.py:_aggregate_cvjp`` (float32)."""
    msg = x[half.src.long()] * rel_all[half.rel.long()] * etab
    return msg * half.norm[:, None]


def aggregate_half(
    x: torch.Tensor,
    rel_all: torch.Tensor,
    etab: torch.Tensor,
    half: GraphHalf,
    n_ent: int,
    msg_dtype: str = "float32",
    seg_sum=segment_sum,
) -> torch.Tensor:
    """Compose + segment-sum one direction half -> ``(N, d_in)`` float32.

    ``msg_dtype='bfloat16'`` rounds the messages to bf16 before the sum
    (the JAX package's ``compute_dtype=bfloat16`` message mode); the sum
    accumulates in float32 either way.  ``seg_sum`` lets a caller run the
    same aggregation through the plain segment-sum on any device."""
    msg = compose_messages(x, rel_all, etab, half).to(_DTYPES[msg_dtype])
    return seg_sum(msg, half.dst, half.indptr, n_ent)


def loop_messages(
    x: torch.Tensor,          # (N, d_in)
    loop_rel: torch.Tensor,   # (1, d_in)
    loop_edge: torch.Tensor,  # (1, d_in)
) -> torch.Tensor:
    """Aggregated self-loop messages as a dense op (reference model.py:91-94:
    N identity edges sharing one loop relation and one loop edge embedding)."""
    return x * loop_rel * loop_edge
