"""Relational message aggregation with its backward (``kgc_gcn_tpu/ops/
scatter.py`` and ``kgc_gcn_tpu/ops/spmm_pallas.py:_aggregate_cvjp``,
``_agg_fwd``, ``_agg_bwd``, ``_segment_sum_few``, ``aggregate_stacked_xla``).

Per edge the message is ``phi(x[src], rel_all[rel]) * etab`` scaled by the
degree norm, where ``phi`` is the composition (``compose_pair``: the
reference's ``mult``, or CompGCN's ``sub`` and ``corr``); the dense projection
comes after aggregation (``(Σ m) @ W == Σ (m @ W)``), so the segment-sum runs
in ``d_in`` and the projection is one (N, d_in) matmul.  Self-loop messages
need no scatter: their aggregation is a dense product.

The MGCN schedules of ``spmm_mode`` and ``ew_impl`` (``models/mgcn.py``):

  * ``halves`` (default): ``aggregate_half`` per direction half.  The message
    is composed in plain tensor ops and summed by K1 over dst; the backward's
    three cotangent products are composed in dst order, ``contrib`` is
    permuted into src order and summed by K1 over ``s_indptr`` into d_x, and
    the relation gradient is a sum into the ``2R+1`` relation rows
    (``segment_sum_few``).  With ``sub`` and ``corr`` the per-edge
    cotangents of ``phi`` replace the products (``sub`` in closed form,
    ``corr`` by autograd through ``torch.fft`` on the per-edge products) and
    the same K1 sums follow; the JAX package sums these two compositions
    with XLA's ``segment_sum`` (``scatter.py:aggregate_half``).
  * ``halves`` with ``ew_impl=pallas``: the same, with the forward's compose
    in one pass of K4a and the backward's three products in one pass of K4b
    (``ops/elementwise.py``).  Unlike the JAX package, which falls back to
    XLA for an edge count with no 128-multiple tile, the card's kernels take
    any E.
  * ``stacked_xla``: ``aggregate_stacked_xla``, the halves path over the
    stacked view (``Graph.stacked``): one K1 launch over 2N rows forward, one
    over the stacked src order for d_x.
  * ``stacked``: ``ops/fused_compose.py:aggregate_stacked`` (K3).

``contrib_dtype`` is the type of the d_x cotangent stream that the backward
permutes into src order and K1 sums in float32: the message type, or bf16
where the model takes the JAX package's opt-in ``MGCN_CONTRIB`` stream
(``KGC_MGCN_CONTRIB``, ``spmm_pallas.py:81,664-668``; ``models/mgcn.py``
decides where it applies).  The JAX package's other backward schedules
(``bwd_perm`` ``operands`` and ``fwdw``, ``spmm_pallas.py:590-605,680-706``)
place the same permutation elsewhere and compute the same gradients
(``operands`` to the bit); the port runs ``contrib`` for all three.

The one-hot relation rows (``rel_compose=onehot``) are a TPU layout of the
same gather; the port runs the gather.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import torch

from kgc_gcn_torch.data.graph import GraphHalf
from kgc_gcn_torch.ops.segment_sum import segment_sum

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# The opt-in bf16 contrib stream of the float32 backward (f32 | bf16).
MGCN_CONTRIB = os.environ.get("KGC_MGCN_CONTRIB", "f32")

# Largest (segments x edges) count for which the few-segment sum is one dense
# product (``spmm_pallas.py:ONEHOT_LIMIT``); above it the sum goes through K1
# over the rel-sorted view.  Tests and chip_smoke.py pass 0 to take K1.
ONEHOT_LIMIT = 256 * 2**20


def _ccorr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Circular correlation along the last axis (HolE / CompGCN ``corr``,
    ``scatter.py:_ccorr``): ``irfft(conj(rfft(a)) * rfft(b))``."""
    d = a.shape[-1]
    return torch.fft.irfft(torch.conj(torch.fft.rfft(a)) * torch.fft.rfft(b),
                           n=d)


def compose_pair(x_j: torch.Tensor, r: torch.Tensor,
                 composition: str) -> torch.Tensor:
    """Entity-relation composition phi(x_j, r) (``scatter.py:compose_pair``)."""
    if composition == "mult":
        return x_j * r
    if composition == "sub":
        return x_j - r
    if composition == "corr":
        return _ccorr(x_j, r)
    raise ValueError(f"unknown composition: {composition!r}")


def compose_messages(
    x: torch.Tensor,          # (N, d_in) entity embeddings
    rel_all: torch.Tensor,    # (2R + 1, d_in) relation embeddings (+ loop row)
    etab: torch.Tensor,       # (E_pad, d_in) THIS half's per-edge embeddings,
                              #   row k belongs to edge position k
    half: GraphHalf,
    composition: str = "mult",
) -> torch.Tensor:
    """Per-edge composed message ``(phi(x[src], rel[rel]) * etab) * norm``, in
    the order of ``spmm_pallas.py:_aggregate_cvjp`` (float32)."""
    msg = compose_pair(x[half.src.long()], rel_all[half.rel.long()],
                       composition) * etab
    return msg * half.norm[:, None]


def _phi_cotangents(xg: torch.Tensor, rg: torch.Tensor, gde: torch.Tensor,
                    composition: str):
    """(phi(xg, rg), d xg, d rg) for the per-edge cotangent ``gde`` of phi
    (``sub`` and ``corr``)."""
    if composition == "sub":
        return xg - rg, gde, -gde
    with torch.enable_grad():
        xg, rg = xg.detach().requires_grad_(), rg.detach().requires_grad_()
        phi = _ccorr(xg, rg)
        d_xg, d_rg = torch.autograd.grad(phi, (xg, rg), gde)
    return phi.detach(), d_xg, d_rg


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
    """Compose + segment-sum of one direction half (or of the stacked view,
    over 2N rows), with the gradients with respect to ``x``, ``rel_all`` and
    ``etab``.  ``ew`` is None (compose in plain tensor ops) or the pair
    ``(compose_msg, bwd_products)`` (K4a and K4b, ``ew_impl=pallas``, which
    compose by multiplication only; ``bwd_products`` None composes the
    backward's products in plain tensor ops)."""

    @staticmethod
    def forward(ctx, x, rel_all, etab, half: GraphHalf, n_rows: int,
                msg_dtype: torch.dtype, seg_sum: Callable, few_limit: int,
                ew: Optional[Tuple[Callable, Optional[Callable]]],
                composition: str, contrib_dtype: torch.dtype):
        if ew is None:
            msg = compose_messages(x, rel_all, etab, half,
                                   composition).to(msg_dtype)
        else:
            # one pass from the norm-folded source rows, in the order of
            # spmm_pallas.py:565-567 ((x[src] * norm) * rg * etab)
            xgn = x[half.src.long()] * half.norm[:, None]
            msg = ew[0](xgn, rel_all[half.rel.long()], etab, msg_dtype)
        ctx.save_for_backward(x, rel_all, etab)
        ctx.half, ctx.msg_dtype, ctx.ew = half, msg_dtype, ew
        ctx.seg_sum, ctx.few_limit = seg_sum, few_limit
        ctx.composition, ctx.contrib_dtype = composition, contrib_dtype
        return seg_sum(msg, half.dst, half.indptr, n_rows)

    @staticmethod
    def backward(ctx, g):
        x, rel_all, etab = ctx.saved_tensors
        half, seg_sum = ctx.half, ctx.seg_sum
        xg = x[half.src.long()]
        rg = rel_all[half.rel.long()]
        gd = g[half.dst.long()] * half.norm[:, None]    # (E, D) per-edge cotangent
        if ctx.ew is not None and ctx.ew[1] is not None:
            # the three products in one pass (spmm_pallas.py:651-658);
            # contrib and d_rel_in come out in the message type
            contrib, d_rel_in, d_etab = ctx.ew[1](gd, xg, rg, etab,
                                                  ctx.msg_dtype)
        else:
            if ctx.composition == "mult":
                contrib = gd * rg * etab
                d_rel_in = gd * xg * etab
                # the table slice is stored in this edge order (positional),
                # so its gradient is the dense per-edge product; padding
                # rows have norm 0
                d_etab = gd * xg * rg
            else:
                phi, contrib, d_rel_in = _phi_cotangents(xg, rg, gd * etab,
                                                         ctx.composition)
                d_etab = gd * phi
            # bf16 messages, or the bf16 contrib stream: cast before the
            # permutation gather, which halves the bytes it moves
            # (BF16_CAST='pre', spmm_pallas.py:664-677)
            d_rel_in = d_rel_in.to(ctx.msg_dtype)
            contrib = contrib.to(ctx.contrib_dtype)
        dx = seg_sum(contrib[half.sperm.long()], half.s_src, half.s_indptr,
                     x.shape[0])
        d_rel = segment_sum_few(d_rel_in, half.rel, rel_all.shape[0],
                                (half.rperm, half.r_indptr, half.r_rel),
                                seg_sum, ctx.few_limit)
        return (dx, d_rel, d_etab) + (None,) * 8


def aggregate_half(
    x: torch.Tensor,
    rel_all: torch.Tensor,
    etab: torch.Tensor,
    half: GraphHalf,
    n_ent: int,
    msg_dtype: str = "float32",
    seg_sum: Callable = segment_sum,
    few_limit: Optional[int] = None,
    ew: Optional[Tuple[Callable, Optional[Callable]]] = None,
    composition: str = "mult",
    contrib_dtype: Optional[str] = None,
) -> torch.Tensor:
    """Compose + segment-sum one direction half -> ``(N, d_in)`` float32,
    differentiable in ``x``, ``rel_all`` and ``etab``.

    ``msg_dtype='bfloat16'`` rounds the messages (and the backward's
    ``contrib`` and relation streams) to bf16 before each sum (the JAX
    package's ``compute_dtype=bfloat16`` message mode); sums accumulate in
    float32 either way.  ``seg_sum`` lets a caller run the same aggregation
    through the plain segment-sum on any device; ``few_limit`` overrides
    ``ONEHOT_LIMIT`` for the relation gradient's sum.  ``ew`` is the pair
    ``(compose_msg, bwd_products)`` of ``ew_impl=pallas`` (K4a and K4b, or
    their plain versions; ``bwd_products`` may be None), or None;
    ``composition`` is phi (``mult`` only with ``ew``).  ``contrib_dtype``
    (default ``msg_dtype``) is the d_x stream's type where the backward
    composes its products in plain tensor ops."""
    return _Aggregate.apply(
        x, rel_all, etab, half, n_ent, _DTYPES[msg_dtype], seg_sum,
        ONEHOT_LIMIT if few_limit is None else few_limit, ew, composition,
        _DTYPES[contrib_dtype or msg_dtype])


def aggregate_stacked_xla(
    x: torch.Tensor,
    rel_all: torch.Tensor,
    etab2: torch.Tensor,      # (2 * E_pad, d): the whole table, stacked order
    stacked,                  # data.graph.GraphStacked
    n_ent: int,
    msg_dtype: str = "float32",
    seg_sum: Callable = segment_sum,
    few_limit: Optional[int] = None,
    composition: str = "mult",
    contrib_dtype: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both halves through one K1 launch (``spmm_pallas.py:
    aggregate_stacked_xla``): the per-half aggregation over the stacked view
    with ``n_rows = 2N``, whose dst ids span [0, 2N); the backward's d_x sums
    both halves' cotangents over the stacked src order in one K1 launch, as
    a ``contrib_dtype`` stream (default ``msg_dtype``).
    Returns ``(in_agg, out_agg)``, each ``(N, d)`` float32."""
    out = _Aggregate.apply(
        x, rel_all, etab2, stacked, 2 * n_ent, _DTYPES[msg_dtype], seg_sum,
        ONEHOT_LIMIT if few_limit is None else few_limit, None, composition,
        _DTYPES[contrib_dtype or msg_dtype])
    return out[:n_ent], out[n_ent:]


def aggregate_half_reference_schedule(
    x: torch.Tensor,
    rel_all: torch.Tensor,
    etab: torch.Tensor,       # (E_pad, d_in) this half's positional slice
    half: GraphHalf,
    weight: torch.Tensor,     # (d_in, d_out) direction weight
    n_ent: int,
) -> torch.Tensor:
    """The reference's schedule, kept for the bench
    (``scatter.py:aggregate_half_reference_schedule``): every edge message is
    projected through the dense weight (as PyG's ``message()``, reference
    model.py:111-118) and summed unsorted into ``(N, d_out)`` with
    ``index_add_``; autograd gives its backward.  It has no kernel in either
    package."""
    msg = (x[half.src.long()] * rel_all[half.rel.long()] * etab) @ weight
    msg = msg * half.norm[:, None]
    out = torch.zeros(n_ent, msg.shape[1], dtype=msg.dtype, device=msg.device)
    return out.index_add(0, half.dst.long(), msg)


def loop_messages(
    x: torch.Tensor,          # (N, d_in)
    loop_rel: torch.Tensor,   # (1, d_in)
    loop_edge: torch.Tensor,  # (1, d_in)
    composition: str = "mult",
) -> torch.Tensor:
    """Aggregated self-loop messages as a dense op (reference model.py:91-94:
    N identity edges sharing one loop relation and one loop edge embedding)."""
    return compose_pair(x, loop_rel, composition) * loop_edge
