"""Relational message aggregation with its backward (the ``mult`` composition
of ``kgc_gcn_tpu/ops/scatter.py`` and ``kgc_gcn_tpu/ops/spmm_pallas.py:
_aggregate_cvjp``, ``_agg_fwd``, ``_agg_bwd``, ``_segment_sum_few``).

Per edge the message is ``x[src] * rel_all[rel] * etab`` scaled by the degree
norm; the dense projection comes after aggregation (``(Σ m) @ W == Σ (m @ W)``),
so the segment-sum runs in ``d_in`` and the projection is one (N, d_in) matmul.
Self-loop messages need no scatter: their aggregation is a dense product.

The backward keeps the JAX package's default schedule (``bwd_perm=contrib``,
``ew_impl=xla``, ``rel_compose=gather``): the three cotangent products are
composed in dst order, ``contrib`` is permuted into src order and summed by K1
over ``s_indptr`` into d_x, and the relation gradient is a sum into the
``2R+1`` relation rows (``segment_sum_few``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from kgc_gcn_torch.data.graph import GraphHalf
from kgc_gcn_torch.ops.segment_sum import segment_sum

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Largest (segments x edges) count for which the few-segment sum is one dense
# product (``spmm_pallas.py:ONEHOT_LIMIT``); above it the sum goes through K1
# over the rel-sorted view.  Tests and chip_smoke.py pass 0 to take K1.
ONEHOT_LIMIT = 256 * 2**20


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


def segment_sum_few(vals: torch.Tensor, ids: torch.Tensor, n_seg: int,
                    rdata: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                    seg_sum: Callable = segment_sum,
                    limit: int = ONEHOT_LIMIT) -> torch.Tensor:
    """(E, D) float32/bf16 values into FEW segments (the 2R+1 relation rows)
    -> (n_seg, D) float32.

    Up to ``limit`` segment-edge pairs the sum is one float32 ``index_add_``;
    above it, ``seg_sum`` (K1 by default) sums the rel-sorted view
    ``rdata = (rperm, r_indptr, r_rel)`` (``spmm_pallas.py:603-636``)."""
    if n_seg * vals.shape[0] > limit:
        rperm, r_indptr, r_rel = rdata
        return seg_sum(vals[rperm.long()], r_rel, r_indptr, n_seg)
    out = torch.zeros(n_seg, vals.shape[1], dtype=torch.float32,
                      device=vals.device)
    return out.index_add_(0, ids.long(), vals.float())


class _Aggregate(torch.autograd.Function):
    """Compose + segment-sum of one direction half, with the gradients with
    respect to ``x``, ``rel_all`` and ``etab``."""

    @staticmethod
    def forward(ctx, x, rel_all, etab, half: GraphHalf, n_ent: int,
                msg_dtype: torch.dtype, seg_sum: Callable, few_limit: int):
        msg = compose_messages(x, rel_all, etab, half).to(msg_dtype)
        ctx.save_for_backward(x, rel_all, etab)
        ctx.half, ctx.msg_dtype = half, msg_dtype
        ctx.seg_sum, ctx.few_limit = seg_sum, few_limit
        return seg_sum(msg, half.dst, half.indptr, n_ent)

    @staticmethod
    def backward(ctx, g):
        x, rel_all, etab = ctx.saved_tensors
        half, seg_sum = ctx.half, ctx.seg_sum
        xg = x[half.src.long()]
        rg = rel_all[half.rel.long()]
        gd = g[half.dst.long()] * half.norm[:, None]    # (E, D) per-edge cotangent
        contrib = gd * rg * etab
        d_rel_in = gd * xg * etab
        # the table slice is stored in this edge order (positional), so its
        # gradient is the dense per-edge product; padding rows have norm 0
        d_etab = gd * xg * rg
        if ctx.msg_dtype != torch.float32:
            # bf16 message mode: cast before the permutation gather, which
            # halves the bytes it moves (BF16_CAST='pre', spmm_pallas.py:669-677)
            contrib = contrib.to(ctx.msg_dtype)
            d_rel_in = d_rel_in.to(ctx.msg_dtype)
        dx = seg_sum(contrib[half.sperm.long()], half.s_src, half.s_indptr,
                     x.shape[0])
        d_rel = segment_sum_few(d_rel_in, half.rel, rel_all.shape[0],
                                (half.rperm, half.r_indptr, half.r_rel),
                                seg_sum, ctx.few_limit)
        return dx, d_rel, d_etab, None, None, None, None, None


def aggregate_half(
    x: torch.Tensor,
    rel_all: torch.Tensor,
    etab: torch.Tensor,
    half: GraphHalf,
    n_ent: int,
    msg_dtype: str = "float32",
    seg_sum: Callable = segment_sum,
    few_limit: Optional[int] = None,
) -> torch.Tensor:
    """Compose + segment-sum one direction half -> ``(N, d_in)`` float32,
    differentiable in ``x``, ``rel_all`` and ``etab``.

    ``msg_dtype='bfloat16'`` rounds the messages (and the backward's
    ``contrib`` and relation streams) to bf16 before each sum (the JAX
    package's ``compute_dtype=bfloat16`` message mode); sums accumulate in
    float32 either way.  ``seg_sum`` lets a caller run the same aggregation
    through the plain segment-sum on any device; ``few_limit`` overrides
    ``ONEHOT_LIMIT`` for the relation gradient's sum."""
    return _Aggregate.apply(
        x, rel_all, etab, half, n_ent, _DTYPES[msg_dtype], seg_sum,
        ONEHOT_LIMIT if few_limit is None else few_limit)


def loop_messages(
    x: torch.Tensor,          # (N, d_in)
    loop_rel: torch.Tensor,   # (1, d_in)
    loop_edge: torch.Tensor,  # (1, d_in)
) -> torch.Tensor:
    """Aggregated self-loop messages as a dense op (reference model.py:91-94:
    N identity edges sharing one loop relation and one loop edge embedding)."""
    return x * loop_rel * loop_edge
