"""Sparse-label BCE and the fused score + BCE classifier: kernels K2a and K2b
of the port, their plain versions, and the losses built on them (the port's
``kgc_gcn_tpu/ops/fused_loss.py``).

The smoothed label is affine in the true-object indicator
(reference data_loader.py:41-43), ``y = base + coeff * multi_hot(label_idx)``
with ``base = 1/N, coeff = 1 - eps`` (``base = 0, coeff = 1`` when eps = 0),
and BCE-with-logits is affine in y, so the loss splits into a DENSE term that
needs no labels and a SPARSE correction over the true entries of each row:

    sum_bn w_b * [relu(s) - base*s + log1p(exp(-|s|))]
      - coeff * sum_b w_b * sum_l s[b, label_idx[b, l]]

divided by ``max(sum w, 1) * N``.  The (B, N) label matrix never exists.

  * ``sparse_bce_with_logits`` takes dense logits (plain PyTorch: the JAX
    version is XLA, ``fused_loss.py:70-120``).
  * ``fused_score_bce`` takes the decoder's query vectors ``h (B, d)`` and the
    entity matrix: the dense term is K2a, ``dense_loss``
    (``csrc/fused_score_bce.cu``, which replaces ``fused_loss.py:_fwd_kernel``)
    and its gradient K2b, ``dense_grads`` (``_bwd_kernel``); the (B, N) score
    matrix never reaches device memory in either direction.  The sparse
    corrections at the true entries are (B, L)-sized PyTorch.

On a CUDA tensor ``dense_loss`` and ``dense_grads`` launch their kernels or
raise; on a CPU tensor they run their plain versions,
``dense_loss_reference`` and ``dense_grads_reference``.  Both losses need
each row of ``label_idx`` to hold UNIQUE entity ids, padded with ``N``
(the data layer guarantees it); pad entries are masked out explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from kgc_gcn_torch.utils.cuda_build import check_launch, load_kernels

# K2a's and K2b's schedule (csrc/fused_score_bce.cu): rows of h per chunk,
# entities per tile, float4 slot strides of the staged h chunk and entity
# tile and of K2b's transposed dl tile, and the widest column windows whose
# operands fit in one block's 232,448 bytes of shared memory (K2a: h, the
# entity tile, two score tiles of 128 x 66 floats, 128 row weights and 16
# warp sums; K2b: h, the entity tile and the dl tile)
_ROWS, _TILE_N = 128, 64
_LD_H, _LD_E, _GRAD_LD_L = 132, 68, 132
_LOSS_MAX_WINDOW, _GRAD_MAX_WINDOW = 200, 248
_LOSS_FIXED_SMEM = 4 * (2 * _ROWS * (_TILE_N + 2) + _ROWS + 16)


@dataclass(frozen=True)
class _TileRuns:
    """Block x owns the 64-entity tiles ``tile_range(x)``."""
    n_tiles: int
    tiles_per_block: int
    blocks: int

    def tile_range(self, block: int) -> range:
        start = block * self.tiles_per_block
        return range(start, min(start + self.tiles_per_block, self.n_tiles))


def _tile_runs(n: int, n_sm: int) -> Tuple[int, int, int]:
    """Runs of 64-entity tiles for about ``n_sm`` blocks, none empty."""
    n_tiles = -(-n // _TILE_N)
    tiles_per_block = -(-n_tiles // max(1, n_sm))
    return n_tiles, tiles_per_block, -(-n_tiles // tiles_per_block)


def _windows(d: int, max_window: int) -> Tuple[int, int]:
    """(window, n_windows): the fewest windows of at most ``max_window``
    columns, a multiple of 8, that cover d >= 1."""
    n_windows = -(-d // max_window)
    per_window = -(-d // n_windows)
    return -(-per_window // 8) * 8, n_windows


@dataclass(frozen=True)
class LossSchedule(_TileRuns):
    """K2a's launch schedule: block (x, y) adds the terms of its tiles and
    of the y-th chunk of 128 rows into one of ``partials``; columns are
    staged in ``n_windows`` windows of ``window``."""
    row_chunks: int
    partials: int
    window: int
    n_windows: int
    smem_bytes: int


def loss_schedule(b: int, n: int, d: int, n_sm: int) -> LossSchedule:
    """Runs of 64-entity tiles, none empty, for about ``n_sm`` blocks over
    all row chunks, and column windows of at most 200 (a multiple of 8)
    for K2a."""
    chunks = -(-b // _ROWS)
    runs = _tile_runs(n, max(1, n_sm // chunks))
    window, n_windows = _windows(d, _LOSS_MAX_WINDOW)
    smem = 16 * (window // 4) * (_LD_H + _LD_E) + _LOSS_FIXED_SMEM
    return LossSchedule(*runs, chunks, runs[2] * chunks, window, n_windows,
                        smem)


@dataclass(frozen=True)
class GradsSchedule(_TileRuns):
    """K2b's launch schedule: block x owns entity tiles
    ``tile_range(x)``, writes one d_h partial of (B rounded up to 128,
    ``ld_partial``) floats, and stages columns in ``n_windows`` windows of
    ``window``."""
    window: int
    n_windows: int
    ld_partial: int
    scratch_floats: int
    smem_bytes: int


def grads_schedule(b: int, n: int, d: int, n_sm: int) -> GradsSchedule:
    """Runs of 64-entity tiles for about ``n_sm`` blocks, none empty, and
    column windows of at most 248 (a multiple of 8) for K2b."""
    n_tiles, tiles_per_block, blocks = _tile_runs(n, n_sm)
    window, n_windows = _windows(d, _GRAD_MAX_WINDOW)
    smem = 16 * (window // 4) * (_LD_H + _LD_E) + 4 * _TILE_N * _GRAD_LD_L
    ld_partial = window * n_windows
    rows = -(-b // _ROWS) * _ROWS   # B in whole row chunks
    return GradsSchedule(n_tiles, tiles_per_block, blocks, window, n_windows,
                         ld_partial, blocks * rows * ld_partial, smem)


def _split_base_coeff(n_ent: int, smooth: float) -> Tuple[float, float]:
    if smooth:
        return 1.0 / n_ent, 1.0 - smooth
    return 0.0, 1.0


def _denom(row_mask: torch.Tensor, n_ent: int) -> torch.Tensor:
    return row_mask.sum().clamp_min(1.0) * n_ent


def _true_entries(label_idx: torch.Tensor, n_ent: int):
    """(valid (B, L) bool, ids (B, L) int64 clamped into [0, N))."""
    valid = label_idx < n_ent
    return valid, label_idx.long().clamp_max(n_ent - 1)


# ------------------------------------------------- level 1: sparse-label BCE

class _SparseBCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, label_idx, row_mask, smooth: float):
        n_ent = logits.shape[1]
        base, coeff = _split_base_coeff(n_ent, smooth)
        dense = ((logits.clamp_min(0.0) - base * logits
                  + torch.log1p(torch.exp(-logits.abs())))
                 * row_mask[:, None]).sum()
        valid, ids = _true_entries(label_idx, n_ent)
        true = torch.where(valid, logits.gather(1, ids), 0.0)
        true_sum = (true.sum(dim=1) * row_mask).sum()
        ctx.save_for_backward(logits, label_idx, row_mask)
        ctx.smooth = smooth
        return (dense - coeff * true_sum) / _denom(row_mask, n_ent)

    @staticmethod
    def backward(ctx, g):
        # d/dx = (sigmoid(x) - base) - coeff * multi_hot: one elementwise pass
        # over (B, N) and a (B, L) correction at the true entries
        logits, label_idx, row_mask = ctx.saved_tensors
        n_ent = logits.shape[1]
        base, coeff = _split_base_coeff(n_ent, ctx.smooth)
        scale = g / _denom(row_mask, n_ent)
        d = (torch.sigmoid(logits) - base) * row_mask[:, None] * scale
        valid, ids = _true_entries(label_idx, n_ent)
        corr = torch.where(valid, (coeff * scale) * row_mask[:, None], 0.0)
        d.scatter_add_(1, ids, -corr)
        return d, None, None, None


def sparse_bce_with_logits(
    logits: torch.Tensor,                     # (B, N)
    label_idx: torch.Tensor,                  # (B, L) unique ids, padded with N
    smooth: float = 0.0,
    row_mask: Optional[torch.Tensor] = None,  # (B,) 1.0 valid / 0.0 padding
) -> torch.Tensor:
    """``bce_with_logits(logits, build_labels(label_idx, N, smooth),
    row_mask)`` without the (B, N) label matrix."""
    if row_mask is None:
        row_mask = logits.new_ones(logits.shape[0])
    return _SparseBCE.apply(logits, label_idx, row_mask, float(smooth))


# ------------------------------------------- level 2: K2a / K2b and the loss

def dense_loss_reference(h, ent, bias, row_mask, base: float) -> torch.Tensor:
    """Plain K2a: sum over (B, N) of ``w_b * [relu(s) - base*s +
    log1p(exp(-|s|))]``, ``s = h @ ent.T + bias`` -> float32 scalar."""
    s = h @ ent.T + bias
    term = s.clamp_min(0.0) - base * s + torch.log1p(torch.exp(-s.abs()))
    return (term * row_mask[:, None]).sum()


def dense_grads_reference(g, h, ent, bias, row_mask, base: float):
    """Plain K2b: ``dl = (sigmoid(s) - base) * w * g`` ->
    (d_h (B, d), d_ent (N, d), d_bias (N,)), all float32."""
    s = h @ ent.T + bias
    dl = (torch.sigmoid(s) - base) * row_mask[:, None] * g
    return dl @ ent, dl.T @ h, dl.sum(dim=0)


def _check(h, ent, bias, row_mask) -> None:
    for name, t in (("h", h), ("ent", ent), ("bias", bias),
                    ("row_mask", row_mask)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if h.dim() != 2 or ent.dim() != 2 or h.shape[1] != ent.shape[1]:
        raise ValueError(f"h (B, d) and ent (N, d) disagree: "
                         f"{tuple(h.shape)}, {tuple(ent.shape)}")
    b, n = h.shape[0], ent.shape[0]
    if tuple(bias.shape) != (n,) or tuple(row_mask.shape) != (b,):
        raise ValueError(f"bias must be ({n},) and row_mask ({b},), got "
                         f"{tuple(bias.shape)}, {tuple(row_mask.shape)}")
    if not (h.device == ent.device == bias.device == row_mask.device):
        raise ValueError("h, ent, bias and row_mask must be on one device")
    if max(b, n, h.shape[1]) >= 2**31 or b * h.shape[1] >= 2**31 \
            or n * h.shape[1] >= 2**31:
        raise ValueError("fused_score_bce takes sizes below 2**31")


def _on_card(*tensors) -> bool:
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"the K2 kernels run on cpu or cuda, not {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the K2 kernels take contiguous tensors")
    return True


def dense_loss(h: torch.Tensor, ent: torch.Tensor, bias: torch.Tensor,
               row_mask: torch.Tensor, base: float) -> torch.Tensor:
    """K2a: the dense term of the loss, a float32 scalar tensor.

    ``dense_loss.launches`` counts the wrapper's launches (one per call:
    the pass over entity tiles and the sum of its partials together)."""
    _check(h, ent, bias, row_mask)
    if not _on_card(h, ent, bias, row_mask):
        return dense_loss_reference(h, ent, bias, row_mask, base)
    b, d = h.shape
    n = ent.shape[0]
    if b == 0 or n == 0:
        return torch.zeros((), dtype=torch.float32, device=h.device)
    if d == 0:   # the JAX kernel refuses d 0 too
        raise ValueError("K2a takes d >= 1")
    out = torch.empty((), dtype=torch.float32, device=h.device)
    sched = loss_schedule(
        b, n, d, torch.cuda.get_device_properties(h.device).multi_processor_count)
    partials = torch.empty(sched.partials, dtype=torch.float32,
                           device=h.device)
    kernels = load_kernels()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        code = kernels.lib.kgc_fused_bce_loss(
            h.data_ptr(), ent.data_ptr(), bias.data_ptr(), row_mask.data_ptr(),
            float(base), partials.data_ptr(), out.data_ptr(), b, n, d,
            sched.tiles_per_block, sched.blocks, sched.window, sched.n_windows,
            stream)
    check_launch(kernels.lib, code, "fused_bce_loss (K2a)")
    dense_loss.launches += 1
    return out


dense_loss.launches = 0


def dense_grads(g: torch.Tensor, h: torch.Tensor, ent: torch.Tensor,
                bias: torch.Tensor, row_mask: torch.Tensor, base: float):
    """K2b: (d_h (B, d), d_ent (N, d), d_bias (N,)) of the dense term scaled
    by the float32 scalar tensor ``g``, all float32.

    ``dense_grads.launches`` counts the wrapper's launches (one per call:
    the pass over entity tiles and the d_h reduction together)."""
    _check(h, ent, bias, row_mask)
    g = g.reshape(1).to(torch.float32)
    if not _on_card(h, ent, bias, row_mask, g):
        return dense_grads_reference(g[0], h, ent, bias, row_mask, base)
    b, d = h.shape
    n = ent.shape[0]
    d_h = torch.empty(b, d, dtype=torch.float32, device=h.device)
    d_ent = torch.empty(n, d, dtype=torch.float32, device=h.device)
    d_bias = torch.empty(n, dtype=torch.float32, device=h.device)
    if b == 0 or n == 0 or d == 0:
        return d_h.zero_(), d_ent.zero_(), d_bias.zero_()
    sched = grads_schedule(
        b, n, d, torch.cuda.get_device_properties(h.device).multi_processor_count)
    scratch = torch.empty(sched.scratch_floats, dtype=torch.float32,
                          device=h.device)
    kernels = load_kernels()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        code = kernels.lib.kgc_fused_bce_grads(
            g.data_ptr(), h.data_ptr(), ent.data_ptr(), bias.data_ptr(),
            row_mask.data_ptr(), float(base), d_h.data_ptr(),
            d_ent.data_ptr(), d_bias.data_ptr(), scratch.data_ptr(),
            b, n, d, sched.tiles_per_block, sched.blocks, sched.window,
            sched.n_windows, stream)
    check_launch(kernels.lib, code, "fused_bce_grads (K2b)")
    dense_grads.launches += 1
    return d_h, d_ent, d_bias


dense_grads.launches = 0


class _FusedScoreBCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, ent, bias, label_idx, row_mask, smooth: float,
                loss_fn: Callable, grads_fn: Callable):
        n_ent = ent.shape[0]
        base, coeff = _split_base_coeff(n_ent, smooth)
        dense = loss_fn(h, ent, bias, row_mask, base)
        # the true entries scored directly from (h, ent): (B, L) work
        valid, ids = _true_entries(label_idx, n_ent)
        x_true = torch.where(
            valid, torch.einsum("bd,bld->bl", h, ent[ids]) + bias[ids], 0.0)
        true_sum = (x_true.sum(dim=1) * row_mask).sum()
        ctx.save_for_backward(h, ent, bias, label_idx, row_mask)
        ctx.smooth, ctx.grads_fn = smooth, grads_fn
        return (dense - coeff * true_sum) / _denom(row_mask, n_ent)

    @staticmethod
    def backward(ctx, g):
        h, ent, bias, label_idx, row_mask = ctx.saved_tensors
        n_ent = ent.shape[0]
        base, coeff = _split_base_coeff(n_ent, ctx.smooth)
        gscale = g / _denom(row_mask, n_ent)
        dh, dent, dbias = ctx.grads_fn(gscale, h, ent, bias, row_mask, base)
        # corrections at the true entries: -coeff * gscale * w_b each; pad
        # entries get weight 0 and their (clamped) rows receive nothing
        valid, ids = _true_entries(label_idx, n_ent)
        cw = torch.where(valid, (coeff * gscale) * row_mask[:, None], 0.0)
        dh = dh - torch.einsum("bl,bld->bd", cw, ent[ids])
        flat = ids.reshape(-1)
        # in place: both are fresh outputs of grads_fn
        dent.index_add_(0, flat, (-cw[:, :, None] * h[:, None, :])
                        .reshape(flat.shape[0], -1))
        dbias.index_add_(0, flat, -cw.reshape(-1))
        return dh, dent, dbias, None, None, None, None, None


def fused_score_bce(
    h: torch.Tensor,                          # (B, d) decoder query vectors
    all_ent: torch.Tensor,                    # (N, d) entity matrix
    ent_bias: torch.Tensor,                   # (N,) per-entity score bias
    label_idx: torch.Tensor,                  # (B, L) unique ids, padded with N
    smooth: float = 0.0,
    row_mask: Optional[torch.Tensor] = None,  # (B,)
    loss_fn: Callable = dense_loss,
    grads_fn: Callable = dense_grads,
) -> torch.Tensor:
    """BCE of ``h @ all_ent.T + ent_bias`` against smoothed multi-hot labels,
    with the (B, N) score matrix never in device memory.  ``loss_fn`` and
    ``grads_fn`` select K2a / K2b (default) or their plain versions."""
    if row_mask is None:
        row_mask = h.new_ones(h.shape[0])
    return _FusedScoreBCE.apply(h, all_ent, ent_bias, label_idx, row_mask,
                                float(smooth), loss_fn, grads_fn)
