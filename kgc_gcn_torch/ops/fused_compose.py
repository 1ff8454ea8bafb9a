"""The ``spmm_mode=stacked`` aggregation: kernel K3 of the port, its plain
version, and ``aggregate_stacked`` with its backward.

``fused_compose(x, src, norm, rel_all, rel, etab, dst, indptr, n_rows)``
computes, for edges sorted by ``dst`` with CSR pointers ``indptr``,

    out[r] = sum over indptr[r] <= e < indptr[r+1] of
             ((x[src[e]] * norm[e]) * rel_all[rel[e]]) * etab[e]    (float32)

— what ``kgc_gcn_tpu/ops/spmm_pallas.py:_fused_compose_segment_sum`` computes
from the pre-gathered ``xgn = x[src] * norm``.  On CUDA tensors it launches
the hand-written kernel ``csrc/fused_compose.cu`` or raises; on CPU tensors
it runs the plain version.  There is no fallback from the card to the plain
version.

The kernel gathers the rows of ``x`` itself and works on fixed chunks of 32
edges (``fused_compose_schedule``): pass A composes and sums each chunk in
edge order, one warp a chunk, writes the rows that lie inside it (and the
zeros of the empty rows around them) and the partial sums of rows cut by a
chunk boundary to a carry; pass B, launched after pass A, adds each cut
row's partials in chunk order (a row of more than 32 chunks in
fixed runs, one a warp, whose sums it adds in run order).  No warp walks
more than one chunk, whatever the degrees (the stacked view's padding
hubs, a power-law entity), and each row's summation order is fixed: two
calls give the same bits.  One call is two CUDA launches;
``fused_compose.launches`` counts calls.  The kernel's header states its
bound.

``aggregate_stacked`` is ``spmm_pallas.py:_aggregate_stacked_cvjp``: both
direction halves through one K3 call over the stacked view's 2N rows, in
float32 whatever ``compute_dtype`` is, and the backward of
``_agg_stacked_bwd`` in plain tensor ops around K1 (d_x over the stacked
src order) and the few-segment relation sum.  The JAX backward's one-hot
hi/lo relation rows are a TPU schedule; the port gathers them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from kgc_gcn_torch.data.graph import GraphStacked
from kgc_gcn_torch.ops.scatter import ONEHOT_LIMIT, segment_sum_few
from kgc_gcn_torch.ops.segment_sum import segment_sum
from kgc_gcn_torch.utils.cuda_build import check_launch, load_kernels


# Edges per chunk of K3's pass A: a warp's lanes each load one edge's ids
# (kChunk in csrc/fused_compose.cu, whose launcher refuses any other value).
FUSED_COMPOSE_CHUNK = 32


class FusedComposeSchedule(NamedTuple):
    """K3's chunks and scratch, from the shape alone (no read of the
    graph)."""
    chunk: int            # pass A's chunk k: edges [k*chunk, (k+1)*chunk)
    n_chunks: int         # pass A's warps
    carry_shape: tuple    # pass A's partials, (n_chunks, 2, d) float32


def fused_compose_schedule(e: int, d: int) -> FusedComposeSchedule:
    """K3's chunks and the carry its launcher (``kgc_fused_compose``)
    expects: slot 0 of chunk k holds the partial of the row of edge
    k*chunk, slot 1 that of the chunk's last row where it starts later."""
    n_chunks = -(-e // FUSED_COMPOSE_CHUNK)
    return FusedComposeSchedule(FUSED_COMPOSE_CHUNK, n_chunks,
                                (n_chunks, 2, d))


def fused_compose_reference(x, src, norm, rel_all, rel, etab, dst, indptr,
                            n_rows: int) -> torch.Tensor:
    """Plain version: the composed messages, then ``index_add_`` at dst.
    ``indptr`` is unused (it only serves the kernel's CSR walk)."""
    del indptr
    msg = ((x[src.long()] * norm[:, None]) * rel_all[rel.long()]) * etab
    out = torch.zeros(n_rows, x.shape[1], dtype=torch.float32, device=x.device)
    return out.index_add_(0, dst.long(), msg)


def _check(x, src, norm, rel_all, rel, etab, dst, indptr, n_rows) -> None:
    d = x.shape[1] if x.dim() == 2 else -1
    e = etab.shape[0] if etab.dim() == 2 else -1
    for name, t in (("x", x), ("rel_all", rel_all), ("etab", etab)):
        if t.dim() != 2 or t.dtype != torch.float32 or t.shape[1] != d:
            raise ValueError(f"{name} must be (rows, {d}) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t, dtype in (("src", src, torch.int32), ("rel", rel, torch.int32),
                           ("dst", dst, torch.int32),
                           ("norm", norm, torch.float32)):
        if tuple(t.shape) != (e,) or t.dtype != dtype:
            raise ValueError(f"{name} must be ({e},) {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if tuple(indptr.shape) != (n_rows + 1,) or indptr.dtype != torch.int32:
        raise ValueError(f"indptr must be ({n_rows + 1},) int32, got "
                         f"{tuple(indptr.shape)} {indptr.dtype}")
    if len({t.device for t in (x, src, norm, rel_all, rel, etab, dst,
                               indptr)}) != 1:
        raise ValueError("fused_compose's operands must be on one device")
    if max(e, n_rows, d, x.shape[0], rel_all.shape[0]) >= 2**31:
        raise ValueError("fused_compose takes sizes below 2**31")


def fused_compose(x: torch.Tensor, src: torch.Tensor, norm: torch.Tensor,
                  rel_all: torch.Tensor, rel: torch.Tensor, etab: torch.Tensor,
                  dst: torch.Tensor, indptr: torch.Tensor,
                  n_rows: int) -> torch.Tensor:
    """Composed messages of (E,) edges sorted by ``dst``, summed per row ->
    (n_rows, d) float32.  ``fused_compose.launches`` counts the kernel's
    calls, each two CUDA launches (never the plain version's calls)."""
    _check(x, src, norm, rel_all, rel, etab, dst, indptr, n_rows)
    if x.device.type == "cpu":
        if n_rows and int(indptr[-1]) > etab.shape[0]:
            raise ValueError("indptr[-1] exceeds the edge count")
        return fused_compose_reference(x, src, norm, rel_all, rel, etab, dst,
                                       indptr, n_rows)
    if x.device.type != "cuda":
        raise ValueError(f"fused_compose runs on cpu or cuda, not {x.device}")
    if not all(t.is_contiguous() for t in (x, src, norm, rel_all, rel, etab,
                                           dst, indptr)):
        raise ValueError("fused_compose's operands must be contiguous")
    e, d = etab.shape
    out = torch.empty(n_rows, d, dtype=torch.float32, device=x.device)
    if n_rows == 0 or d == 0:
        return out
    sched = fused_compose_schedule(e, d)
    carry = torch.empty(sched.carry_shape, dtype=torch.float32,
                        device=x.device)
    # the index ranges are asserted inside the kernel (a host check here
    # would synchronise the stream on every launch)
    kernels = load_kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = kernels.lib.kgc_fused_compose(
            x.data_ptr(), src.data_ptr(), norm.data_ptr(), rel_all.data_ptr(),
            rel.data_ptr(), etab.data_ptr(), dst.data_ptr(), indptr.data_ptr(),
            out.data_ptr(), carry.data_ptr(), n_rows, e, d, x.shape[0],
            rel_all.shape[0], sched.chunk, stream)
    check_launch(kernels.lib, code, "fused_compose")
    fused_compose.launches += 1
    return out


fused_compose.launches = 0


class _AggregateStacked(torch.autograd.Function):
    """Both halves' compose + segment-sum over the stacked view, with the
    gradients with respect to ``x``, ``rel_all`` and the whole table."""

    @staticmethod
    def forward(ctx, x, rel_all, etab, st: GraphStacked, n_ent: int,
                fused: Callable, seg_sum: Callable, few_limit: int):
        ctx.save_for_backward(x, rel_all, etab)
        ctx.st, ctx.seg_sum, ctx.few_limit = st, seg_sum, few_limit
        return fused(x, st.src, st.norm, rel_all, st.rel, etab, st.dst2,
                     st.indptr, 2 * n_ent)

    @staticmethod
    def backward(ctx, g):
        x, rel_all, etab = ctx.saved_tensors
        st, seg_sum = ctx.st, ctx.seg_sum
        norm = st.norm[:, None]
        gdst = g[st.dst2.long()]                   # (2E_pad, d) cotangent rows
        gdn = gdst * norm
        # xgn is recomputed: the forward never builds it (K3 gathers x
        # itself), and saving it would hold a (2E_pad, d) array over the step
        xgn = x[st.src.long()] * norm
        gx = gdst * xgn
        rel_rows = rel_all[st.rel.long()]
        # d_x: both halves' cotangents summed over src in one K1 launch
        contrib = gdn * rel_rows * etab
        dx = seg_sum(contrib[st.sperm.long()], st.s_src, st.s_indptr,
                     x.shape[0])
        d_rel = segment_sum_few(gx * etab, st.rel, rel_all.shape[0],
                                (st.rperm, st.r_indptr, st.r_rel), seg_sum,
                                ctx.few_limit)
        # positional table: its gradient is the dense per-edge product
        d_etab = gx * rel_rows
        return dx, d_rel, d_etab, None, None, None, None, None


def aggregate_stacked(
    x: torch.Tensor,
    rel_all: torch.Tensor,
    etab2: torch.Tensor,      # (2 * E_pad, d): the whole table, stacked order
    stacked: GraphStacked,
    n_ent: int,
    fused: Callable = fused_compose,
    seg_sum: Callable = segment_sum,
    few_limit: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both direction halves' aggregations ``(in_agg, out_agg)``, each
    ``(N, d)`` float32, from one K3 call, differentiable in ``x``,
    ``rel_all`` and ``etab2``.  ``fused`` and ``seg_sum`` let a caller run
    the same aggregation through the plain versions; ``few_limit``
    overrides ``ONEHOT_LIMIT`` for the relation gradient's sum."""
    out = _AggregateStacked.apply(
        x, rel_all, etab2, stacked, n_ent, fused, seg_sum,
        ONEHOT_LIMIT if few_limit is None else few_limit)
    return out[:n_ent], out[n_ent:]
