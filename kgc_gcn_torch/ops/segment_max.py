"""Sorted CSR segment-max: kernel K5 of the port and its plain version.

``segment_max(logits, dst, indptr, n_rows)`` computes, for (E, H) float32
logits whose destination ids ``dst`` are non-decreasing with CSR pointers
``indptr``,

    out[r] = max over indptr[r] <= e < indptr[r+1] of logits[e]    (float32)

with -inf for rows that have no edges — what
``kgc_gcn_tpu/ops/spmm_pallas.py:segment_max_sorted`` computes.  It is not
differentiable: its one caller, the RGAT segment softmax, feeds it detached
logits (the max subtraction's gradient is exactly zero).  On a CUDA tensor it
launches the hand-written kernel ``csrc/segment_max.cu`` (one warp per
destination row; its header states its bound and its NaN rule) or raises; on
a CPU tensor it runs the plain version.  There is no fallback from the card
to the plain version.
"""

from __future__ import annotations

import torch

from kgc_gcn_torch.utils.cuda_build import check_launch, load_kernels


def segment_max_reference(logits: torch.Tensor, dst: torch.Tensor,
                          indptr: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Plain version: ``scatter_reduce_(..., "amax")`` into -inf.
    ``indptr`` is unused (it only serves the kernel's CSR walk)."""
    del indptr
    out = torch.full((n_rows, logits.shape[1]), float("-inf"),
                     dtype=torch.float32, device=logits.device)
    index = dst.long()[:, None].expand(-1, logits.shape[1])
    return out.scatter_reduce_(0, index, logits, "amax")


def _check(logits, dst, indptr, n_rows) -> None:
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise ValueError(f"logits must be (E, H) float32, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    e = logits.shape[0]
    if tuple(dst.shape) != (e,) or dst.dtype != torch.int32:
        raise ValueError(f"dst must be ({e},) int32, got "
                         f"{tuple(dst.shape)} {dst.dtype}")
    if tuple(indptr.shape) != (n_rows + 1,) or indptr.dtype != torch.int32:
        raise ValueError(f"indptr must be ({n_rows + 1},) int32, got "
                         f"{tuple(indptr.shape)} {indptr.dtype}")
    if not (logits.device == dst.device == indptr.device):
        raise ValueError("logits, dst and indptr must be on one device")
    if e >= 2**31 or n_rows >= 2**31 or logits.shape[1] >= 2**31:
        raise ValueError("segment_max takes sizes below 2**31")


def segment_max(logits: torch.Tensor, dst: torch.Tensor, indptr: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """(E, H) float32 logits sorted by ``dst`` -> (n_rows, H) float32, -inf
    on empty rows.

    ``segment_max.launches`` counts the kernel launches (never the plain
    version's calls)."""
    _check(logits, dst, indptr, n_rows)
    if logits.device.type == "cpu":
        if n_rows and int(indptr[-1]) > logits.shape[0]:
            raise ValueError("indptr[-1] exceeds the edge count")
        return segment_max_reference(logits, dst, indptr, n_rows)
    if logits.device.type != "cuda":
        raise ValueError(f"segment_max runs on cpu or cuda, not {logits.device}")
    if not (logits.is_contiguous() and indptr.is_contiguous()):
        raise ValueError("logits and indptr must be contiguous")
    h = logits.shape[1]
    out = torch.empty(n_rows, h, dtype=torch.float32, device=logits.device)
    if n_rows == 0 or h == 0:
        return out
    # indptr[-1] <= E is asserted inside the kernel (a host check here would
    # synchronise the stream on every launch)
    kernels = load_kernels()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        code = kernels.lib.kgc_segment_max(
            logits.data_ptr(), indptr.data_ptr(), out.data_ptr(), n_rows,
            logits.shape[0], h, stream)
    check_launch(kernels.lib, code, "segment_max")
    segment_max.launches += 1
    return out


segment_max.launches = 0
