"""The RGAT attention's differentiable gathers and sums over a sorted half
(K6 of the port): the four custom-gradient wrappers of
``kgc_gcn_tpu/ops/spmm_pallas.py:1554-1683`` as ``torch.autograd.Function``s.

  * ``edge_compose(h, rel_mult, half)``: ``z = h[src] * rel_mult[rel]``, the
    edge message shared by the attention logits and the weighted
    aggregation.  Backward: d_h by summing ``(g * rel_mult[rel])[sperm]``
    over the src-sorted view (K1 over ``s_indptr``); d_rel_mult by
    ``segment_sum_few`` over the 2R+1 relation segments, sliced to the
    table's 2R rows.
  * ``segment_sum_sorted(vals, dst, indptr, n)``: forward K1; backward the
    gather ``g[dst]``.
  * ``gather_rows_sorted(table, idx, indptr, n)``: forward ``table[idx]``;
    backward K1 over ``indptr`` (``idx`` non-decreasing).
  * ``gather_rows_few(table, idx, n_seg, rdata)``: forward ``table[idx]``
    for a small table; backward ``segment_sum_few``, sliced to the table's
    rows.

Each takes the segment-sum to run (``seg_sum``, K1 by default): a kernel
bundle's ``seg_sum`` moves forward and backward onto the plain version too.

``EDGE_CONTRIB`` (``KGC_EDGE_CONTRIB``, ``spmm_pallas.py:77,1588-1596``):
``bf16`` casts ``edge_compose``'s d_h stream to bf16 before its permutation,
and K1 sums it in float32.  It applies where the JAX package runs
``edge_compose``, on its ``use_pallas`` path: ``models/rgat.py`` passes
``edge_compose`` the stream's type.
"""

from __future__ import annotations

import os
from typing import Callable, Tuple

import torch

from kgc_gcn_torch.data.graph import GraphHalf
from kgc_gcn_torch.ops.scatter import segment_sum_few
from kgc_gcn_torch.ops.segment_sum import segment_sum

# The opt-in bf16 d_h stream of the edge message's backward (f32 | bf16).
EDGE_CONTRIB = os.environ.get("KGC_EDGE_CONTRIB", "f32")


class _EdgeCompose(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, rel_mult, half: GraphHalf, seg_sum: Callable,
                contrib_dtype: torch.dtype):
        ctx.save_for_backward(h, rel_mult)
        ctx.half, ctx.seg_sum = half, seg_sum
        ctx.contrib_dtype = contrib_dtype
        return h[half.src.long()] * rel_mult[half.rel.long()]

    @staticmethod
    def backward(ctx, g):
        h, rel_mult = ctx.saved_tensors
        half, seg_sum = ctx.half, ctx.seg_sum
        contrib = (g * rel_mult[half.rel.long()]).to(ctx.contrib_dtype)
        d_h = seg_sum(contrib[half.sperm.long()], half.s_src, half.s_indptr,
                      h.shape[0])
        n_seg = half.r_indptr.shape[0] - 1
        d_rel = segment_sum_few(g * h[half.src.long()], half.rel, n_seg,
                                (half.rperm, half.r_indptr, half.r_rel),
                                seg_sum)[:rel_mult.shape[0]]
        return d_h, d_rel, None, None, None


class _SegmentSumSorted(torch.autograd.Function):

    @staticmethod
    def forward(ctx, vals, dst, indptr, n_rows: int, seg_sum: Callable):
        ctx.save_for_backward(dst)
        return seg_sum(vals.contiguous(), dst, indptr, n_rows)

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        return g[dst.long()], None, None, None, None


class _GatherRowsSorted(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, idx, indptr, n_rows: int, seg_sum: Callable):
        ctx.save_for_backward(idx, indptr)
        ctx.n_rows, ctx.seg_sum = n_rows, seg_sum
        return table[idx.long()]

    @staticmethod
    def backward(ctx, g):
        idx, indptr = ctx.saved_tensors
        return (ctx.seg_sum(g.contiguous(), idx, indptr, ctx.n_rows),
                None, None, None, None)


class _GatherRowsFew(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, idx, n_seg: int, rdata, seg_sum: Callable):
        ctx.save_for_backward(idx, *rdata)
        ctx.n_seg, ctx.t_rows, ctx.seg_sum = n_seg, table.shape[0], seg_sum
        return table[idx.long()]

    @staticmethod
    def backward(ctx, g):
        idx, *rdata = ctx.saved_tensors
        d_tab = segment_sum_few(g, idx, ctx.n_seg, tuple(rdata),
                                ctx.seg_sum)[:ctx.t_rows]
        return d_tab, None, None, None, None


def edge_compose(h: torch.Tensor, rel_mult: torch.Tensor, half: GraphHalf,
                 seg_sum: Callable = segment_sum,
                 contrib_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, d) entities and (2R, d) relation rows -> (E, d) edge messages
    ``h[src] * rel_mult[rel]`` of one half, in its dst-sorted edge order;
    the backward permutes its d_h stream as ``contrib_dtype``."""
    return _EdgeCompose.apply(h, rel_mult, half, seg_sum, contrib_dtype)


def segment_sum_sorted(vals: torch.Tensor, dst: torch.Tensor,
                       indptr: torch.Tensor, n_rows: int,
                       seg_sum: Callable = segment_sum) -> torch.Tensor:
    """(E, D) float32 values sorted by ``dst`` -> (n_rows, D) float32 sums,
    differentiable in ``vals``."""
    return _SegmentSumSorted.apply(vals, dst, indptr, n_rows, seg_sum)


def gather_rows_sorted(table: torch.Tensor, idx: torch.Tensor,
                       indptr: torch.Tensor, n_rows: int,
                       seg_sum: Callable = segment_sum) -> torch.Tensor:
    """``table[idx]`` for non-decreasing ``idx`` with CSR pointers
    ``indptr`` over the table's ``n_rows`` rows, differentiable in
    ``table``."""
    return _GatherRowsSorted.apply(table, idx, indptr, n_rows, seg_sum)


def gather_rows_few(table: torch.Tensor, idx: torch.Tensor, n_seg: int,
                    rdata: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                    seg_sum: Callable = segment_sum) -> torch.Tensor:
    """``table[idx]`` for a small table whose ids lie in ``n_seg`` segments
    (``rdata = (rperm, r_indptr, r_rel)``, the half's rel-sorted view),
    differentiable in ``table``."""
    return _GatherRowsFew.apply(table, idx, n_seg, rdata, seg_sum)
