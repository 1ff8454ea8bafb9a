"""Basis-decomposed R-GCN aggregation: kernels K7 and K8 of the port, their
plain versions, and the autograd function built on them (the port's
``kgc_gcn_tpu/ops/spmm_pallas.py:basis_aggregate_fused`` and its VJP).

For one direction half with (E, d) messages ``msg = x[src] * norm`` and (E, B)
coefficients ``a = coeff[rel]``, over edges sorted by destination:

  * ``basis_segment_sum`` (K7): ``out[n, b*d + j] = Σ_{e into n} a[e,b] ·
    msg[e,j]``, (n_rows, B·d) float32; the (E, B·d) expansion never reaches
    device memory.  Plain version: ``index_add_`` of that expansion.  Rows
    of more than ``BASIS_SUM_PIECE`` edges are summed in fixed pieces and
    their partials added in piece order (``basis_sum_schedule``).
  * ``basis_backward`` (K8): per edge e into n, with ``sel = g[n]`` viewed as
    (B, d), ``d_msg[e] = Σ_b a[e,b] · sel[b]`` and ``d_a[e,b] = sel[b] ·
    msg[e]``.  Plain version: the gather ``g[dst]`` and two einsums (the JAX
    fallback, ``spmm_pallas.py:1536-1542``).
  * ``basis_aggregate``: forward through K7; backward through K8, then
    ``d_x`` by permuting ``d_msg · norm`` into src order and summing it with
    K1 over ``s_indptr``, and ``d_coeff`` with ``segment_sum_few`` over the
    relation rows.

``BASIS_READBACK`` (``KGC_BASIS_READBACK``, ``spmm_pallas.py:86,1515-1525``)
picks how ``d_msg`` is read back into src order for d_x: ``wide`` and
``narrow`` (the default and a TPU layout of the same numbers) permute the
float32 ``d_msg · norm``; ``bf16`` casts ``d_msg`` and the src-order norm to
bf16 first and multiplies them in bf16, and K1 sums the product in float32.
It applies where the JAX package's band backward runs: ``use_pallas``, at
most 128 bases; ``models/rgcn.py`` passes ``basis_aggregate`` the
readback's type.

Both wrappers run their plain version on a CPU tensor and launch their
kernel (``csrc/basis_rgcn.cu``) on a CUDA tensor or raise.  Where a whole
row does not fit in one K8 block's shared memory, K8 takes d in column
windows (``basis_bwd_window``), so it runs at every width for B up to 436
(the JAX package's kernel takes B up to 128).  ``.launches`` counts
kernel calls only.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import torch

from kgc_gcn_torch.data.graph import GraphHalf
from kgc_gcn_torch.ops.scatter import segment_sum_few
from kgc_gcn_torch.utils.cuda_build import check_launch, load_kernels

# The backward's src-order readback of d_msg (wide | narrow | bf16).
BASIS_READBACK = os.environ.get("KGC_BASIS_READBACK", "wide")
# The JAX package's band backward (and so its readback knob) takes at most
# this many bases (rgcn.py:prepare_kernels).
BASIS_READBACK_MAX_BASES = 128

# Shared memory K8 may ask for (one block's opt-in maximum on the H100,
# kMaxSmem in csrc/basis_rgcn.cu).
BASIS_BWD_MAX_SMEM = 232448
# K7: rows of more than this many edges are summed in pieces of this many
# edges (csrc/basis_rgcn.cu, pass A), their partials added by pass B.
BASIS_SUM_PIECE = 256


def basis_bwd_smem_bytes(d: int, nb: int) -> int:
    """Shared memory K8 needs for one span of 64 edges at d staged columns
    (``bwd_smem_bytes`` in csrc/basis_rgcn.cu): a row's cotangent, (B
    rounded up to 4) x S, the span's messages (64 x S), coefficients
    (64 x B rounded up to 4) and d_a rows (64 x B), and 132 ints of run
    bookkeeping; S is d rounded up to 4 with an odd quotient by 4."""
    nb4 = -(-nb // 4) * 4
    s = -(-d // 4) * 4
    s += 4 * (s // 4 % 2 == 0)
    span = 64                           # kSpan in csrc/basis_rgcn.cu
    return 4 * (nb4 * s + span * s + span * nb4 + span * nb + 2 * span + 4)


def basis_bwd_window(d: int, nb: int) -> int:
    """Columns of d that one K8 block stages at a time: d where a whole row
    fits in shared memory (at B 30 d up to 556, at B 128 d up to 212), else
    the fewest windows of a multiple of 4 columns that fit, made as even as
    the multiple allows (B 128, d 256: two of 128); 0 where not even 4
    columns fit (B above 436)."""
    if basis_bwd_smem_bytes(d, nb) <= BASIS_BWD_MAX_SMEM:
        return d
    w = (d - 1) // 4 * 4
    while w > 0 and basis_bwd_smem_bytes(w, nb) > BASIS_BWD_MAX_SMEM:
        w -= 4
    if w <= 0:
        return 0
    per = -(-d // -(-d // w))                # columns of the fewest windows
    return -(-per // 4) * 4


class BasisSumSchedule(NamedTuple):
    """K7's pieces and scratch, from the shape alone (no read of the
    graph)."""
    piece: int            # a heavy row has more edges than this
    n_pieces: int         # pass A's first blocks: pieces [p*piece, (p+1)*piece)
    carry_shape: tuple    # pass A's partials, (n_pieces, 2, B*d) float32


def basis_sum_schedule(e: int, d: int, nb: int) -> BasisSumSchedule:
    """K7's pieces and the carry its launcher (``kgc_basis_sum`` in
    csrc/basis_rgcn.cu) expects: pass A sums light rows whole and heavy
    rows' pieces into the carry; pass B adds each heavy row's partials in
    piece order."""
    piece = BASIS_SUM_PIECE
    n_pieces = -(-e // piece)
    return BasisSumSchedule(piece, n_pieces, (n_pieces, 2, nb * d))


def basis_segment_sum_reference(msg: torch.Tensor, a: torch.Tensor,
                                dst: torch.Tensor, indptr: torch.Tensor,
                                n_rows: int) -> torch.Tensor:
    """Plain K7: ``index_add_`` of the (E, B·d) expansion at ``dst``."""
    del indptr
    e, d = msg.shape
    expansion = (msg[:, None, :] * a[:, :, None]).reshape(e, a.shape[1] * d)
    out = torch.zeros(n_rows, a.shape[1] * d, dtype=torch.float32,
                      device=msg.device)
    return out.index_add_(0, dst.long(), expansion)


def basis_backward_reference(g: torch.Tensor, msg: torch.Tensor,
                             a: torch.Tensor, dst: torch.Tensor,
                             indptr: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K8: gather ``g[dst]`` as (E, B, d), then the two contractions."""
    del indptr
    e, d = msg.shape
    sel = g[dst.long()].view(e, a.shape[1], d)
    return (torch.einsum("ebd,eb->ed", sel, a),
            torch.einsum("ebd,ed->eb", sel, msg))


def _check(msg, a, dst, indptr, n_rows, what: str) -> None:
    if msg.dim() != 2 or msg.dtype != torch.float32:
        raise ValueError(f"{what}: msg must be (E, d) float32, got "
                         f"{tuple(msg.shape)} {msg.dtype}")
    e = msg.shape[0]
    if a.dim() != 2 or a.shape[0] != e or a.dtype != torch.float32:
        raise ValueError(f"{what}: a must be ({e}, B) float32, got "
                         f"{tuple(a.shape)} {a.dtype}")
    if tuple(dst.shape) != (e,) or dst.dtype != torch.int32:
        raise ValueError(f"{what}: dst must be ({e},) int32, got "
                         f"{tuple(dst.shape)} {dst.dtype}")
    if tuple(indptr.shape) != (n_rows + 1,) or indptr.dtype != torch.int32:
        raise ValueError(f"{what}: indptr must be ({n_rows + 1},) int32, got "
                         f"{tuple(indptr.shape)} {indptr.dtype}")
    if not (msg.device == a.device == dst.device == indptr.device):
        raise ValueError(f"{what}: operands must be on one device")
    if e >= 2**31 or n_rows * a.shape[1] * msg.shape[1] >= 2**31:
        raise ValueError(f"{what} takes sizes below 2**31")


def _on_card(t: torch.Tensor, what: str) -> bool:
    """False for a CPU tensor (plain version), True for a CUDA tensor."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")
    return True


def basis_segment_sum(msg: torch.Tensor, a: torch.Tensor, dst: torch.Tensor,
                      indptr: torch.Tensor, n_rows: int, *,
                      overlap: bool = True) -> torch.Tensor:
    """(E, d) messages and (E, B) coefficients sorted by ``dst`` ->
    (n_rows, B·d) float32 (K7 on the card).

    On the card, K7's pass A sums each row of at most ``BASIS_SUM_PIECE``
    edges in one block and cuts longer rows into fixed pieces of the edge
    list, whose partials pass B adds in piece order: no block walks more
    than one piece, each row's order is fixed (two calls give the same
    bits), and nothing syncs the host.  One call is two CUDA launches;
    ``basis_segment_sum.launches`` counts calls.  Pass B is launched to
    overlap pass A's tail; ``overlap=False`` starts it after pass A has
    ended, so that a profiler times each pass alone."""
    _check(msg, a, dst, indptr, n_rows, "basis_segment_sum")
    if not _on_card(msg, "basis_segment_sum"):
        return basis_segment_sum_reference(msg, a, dst, indptr, n_rows)
    if not (msg.is_contiguous() and a.is_contiguous()
            and dst.is_contiguous() and indptr.is_contiguous()):
        raise ValueError("basis_segment_sum: msg, a, dst and indptr must be "
                         "contiguous")
    e, d = msg.shape
    nb = a.shape[1]
    out = torch.empty(n_rows, nb * d, dtype=torch.float32, device=msg.device)
    if n_rows == 0 or d == 0 or nb == 0:
        return out
    sched = basis_sum_schedule(e, d, nb)
    carry = torch.empty(sched.carry_shape, dtype=torch.float32,
                        device=msg.device)
    kernels = load_kernels()
    with torch.cuda.device(msg.device):
        stream = torch.cuda.current_stream(msg.device).cuda_stream
        code = kernels.lib.kgc_basis_sum(
            msg.data_ptr(), a.data_ptr(), dst.data_ptr(), indptr.data_ptr(),
            out.data_ptr(), carry.data_ptr(), n_rows, e, d, nb, sched.piece,
            int(overlap), stream)
    check_launch(kernels.lib, code, "basis_segment_sum")
    basis_segment_sum.launches += 1
    return out


basis_segment_sum.launches = 0


def basis_backward(g: torch.Tensor, msg: torch.Tensor, a: torch.Tensor,
                   dst: torch.Tensor, indptr: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_rows, B·d) cotangent -> (d_msg (E, d), d_a (E, B)) float32 (K8 on
    the card).  The kernel reads each edge's row from ``dst``; ``indptr``
    gives n_rows.  A K8 block stages ``basis_bwd_window(d, B)`` columns of
    a row at a time: all d where they fit in its shared memory (config 3's
    d 100 needs 54,800 bytes of the 232,448, the 2-layer d 200 94,736),
    else windows of d (B 128 at d 256: two of 128 columns).  Above B 436
    not even 4 columns fit, and the card raises."""
    n_rows = indptr.shape[0] - 1
    _check(msg, a, dst, indptr, n_rows, "basis_backward")
    e, d = msg.shape
    nb = a.shape[1]
    if tuple(g.shape) != (n_rows, nb * d) or g.dtype != torch.float32:
        raise ValueError(f"basis_backward: g must be ({n_rows}, {nb * d}) "
                         f"float32, got {tuple(g.shape)} {g.dtype}")
    if g.device != msg.device:
        raise ValueError("basis_backward: operands must be on one device")
    if not _on_card(msg, "basis_backward"):
        return basis_backward_reference(g, msg, a, dst, indptr)
    if not (g.is_contiguous() and msg.is_contiguous() and a.is_contiguous()
            and dst.is_contiguous()):
        raise ValueError("basis_backward: g, msg, a and dst must be "
                         "contiguous")
    d_msg = torch.empty(e, d, dtype=torch.float32, device=msg.device)
    d_a = torch.empty(e, nb, dtype=torch.float32, device=msg.device)
    if e == 0 or n_rows == 0 or d == 0 or nb == 0:
        return d_msg, d_a
    window = basis_bwd_window(d, nb)
    if window == 0:
        raise ValueError(
            f"basis_backward: num_bases={nb} needs "
            f"{basis_bwd_smem_bytes(4, nb)} bytes of shared memory even for "
            f"4 columns, above the {BASIS_BWD_MAX_SMEM} one block may use")
    kernels = load_kernels()
    with torch.cuda.device(msg.device):
        stream = torch.cuda.current_stream(msg.device).cuda_stream
        code = kernels.lib.kgc_basis_bwd(
            g.data_ptr(), msg.data_ptr(), a.data_ptr(), dst.data_ptr(),
            d_msg.data_ptr(), d_a.data_ptr(), n_rows, e, d, nb, window,
            stream)
    check_launch(kernels.lib, code, "basis_backward")
    basis_backward.launches += 1
    return d_msg, d_a


basis_backward.launches = 0


class _BasisAggregate(torch.autograd.Function):
    """One direction half's basis aggregation, differentiable in ``x`` and
    ``coeff`` (``spmm_pallas.py:_basis_agg_fwd``, ``_basis_agg_bwd``)."""

    @staticmethod
    def forward(ctx, x, coeff, half: GraphHalf, n_ent: int, kernels,
                readback_dtype: torch.dtype):
        msg = x[half.src.long()] * half.norm[:, None]
        a = coeff[half.rel.long()]
        ctx.save_for_backward(msg, a)
        ctx.half, ctx.kernels, ctx.n_coeff = half, kernels, coeff.shape[0]
        ctx.readback_dtype = readback_dtype
        return kernels.basis_sum(msg, a, half.dst, half.indptr, n_ent)

    @staticmethod
    def backward(ctx, g):
        msg, a = ctx.saved_tensors
        half, kernels = ctx.half, ctx.kernels
        d_msg, d_a = kernels.basis_bwd(g.contiguous(), msg, a, half.dst,
                                       half.indptr)
        sperm = half.sperm.long()
        if ctx.readback_dtype == torch.bfloat16:
            # bf16 before the permutation, the product rounded to bf16
            # (spmm_pallas.py:1517-1524)
            contrib = (d_msg.to(torch.bfloat16)[sperm]
                       * half.s_norm.to(torch.bfloat16)[:, None])
        else:
            contrib = (d_msg * half.norm[:, None])[sperm]
        d_x = kernels.seg_sum(contrib, half.s_src, half.s_indptr,
                              half.s_indptr.shape[0] - 1)
        # the rel-sorted view's pointers cover every relation row of the
        # graph (2R + 1); the coefficient table has the first 2R of them
        n_seg = half.r_indptr.shape[0] - 1
        d_coeff = segment_sum_few(d_a, half.rel, n_seg,
                                  (half.rperm, half.r_indptr, half.r_rel),
                                  kernels.seg_sum)[:ctx.n_coeff]
        return d_x, d_coeff, None, None, None, None


def basis_aggregate(x: torch.Tensor, coeff: torch.Tensor, half: GraphHalf,
                    n_ent: int, kernels,
                    readback_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """(N, d) entities and (2R, B) coefficients -> (N, B·d) float32 per-basis
    aggregates of one direction half; ``kernels`` is an
    ``ops.kernels.Kernels`` bundle (``basis_sum``, ``basis_bwd``,
    ``seg_sum``); ``readback_dtype`` bf16 takes ``BASIS_READBACK=bf16``'s
    readback, float32 the default's."""
    return _BasisAggregate.apply(x, coeff, half, n_ent, kernels,
                                 readback_dtype)
