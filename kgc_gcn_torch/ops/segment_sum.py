"""Sorted CSR segment-sum: kernel K1 of the port and its plain version.

``segment_sum(msg, dst, indptr, n_rows)`` computes, for (E, D) messages whose
destination ids ``dst`` are non-decreasing with CSR pointers ``indptr``,

    out[r] = sum over indptr[r] <= e < indptr[r+1] of msg[e]     (float32)

with zeros for rows that have no edges — what
``kgc_gcn_tpu/ops/spmm_pallas.py:segment_sum_pallas`` computes.  On a CUDA
tensor it launches the hand-written kernel ``csrc/segment_sum.cu`` (one warp
per destination row, float32 accumulation; its header states its bound) or
raises; on a CPU tensor it runs the plain version.  There is no fallback from
the card to the plain version.
"""

from __future__ import annotations

import torch

from kgc_gcn_torch.utils.cuda_build import check_launch, load_kernels

_MSG_DTYPES = (torch.float32, torch.bfloat16)


def segment_sum_reference(msg: torch.Tensor, dst: torch.Tensor,
                          indptr: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Plain version: ``index_add_`` of the float32-widened messages at dst.
    ``indptr`` is unused (it only serves the kernel's CSR walk)."""
    del indptr
    out = torch.zeros(n_rows, msg.shape[1], dtype=torch.float32,
                      device=msg.device)
    return out.index_add_(0, dst.long(), msg.float())


def _check(msg, dst, indptr, n_rows) -> None:
    if msg.dim() != 2 or msg.dtype not in _MSG_DTYPES:
        raise ValueError(f"msg must be (E, D) float32 or bfloat16, got "
                         f"{tuple(msg.shape)} {msg.dtype}")
    e = msg.shape[0]
    if tuple(dst.shape) != (e,) or dst.dtype != torch.int32:
        raise ValueError(f"dst must be ({e},) int32, got "
                         f"{tuple(dst.shape)} {dst.dtype}")
    if tuple(indptr.shape) != (n_rows + 1,) or indptr.dtype != torch.int32:
        raise ValueError(f"indptr must be ({n_rows + 1},) int32, got "
                         f"{tuple(indptr.shape)} {indptr.dtype}")
    if not (msg.device == dst.device == indptr.device):
        raise ValueError("msg, dst and indptr must be on one device")
    if e >= 2**31 or n_rows >= 2**31 or msg.shape[1] >= 2**31:
        raise ValueError("segment_sum takes sizes below 2**31")


def segment_sum(msg: torch.Tensor, dst: torch.Tensor, indptr: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """(E, D) float32/bfloat16 messages sorted by ``dst`` -> (n_rows, D) float32.

    ``segment_sum.launches`` counts the kernel launches (never the plain
    version's calls)."""
    _check(msg, dst, indptr, n_rows)
    if msg.device.type == "cpu":
        if n_rows and int(indptr[-1]) > msg.shape[0]:
            raise ValueError("indptr[-1] exceeds the edge count")
        return segment_sum_reference(msg, dst, indptr, n_rows)
    if msg.device.type != "cuda":
        raise ValueError(f"segment_sum runs on cpu or cuda, not {msg.device}")
    if not (msg.is_contiguous() and indptr.is_contiguous()):
        raise ValueError("msg and indptr must be contiguous")
    d = msg.shape[1]
    out = torch.empty(n_rows, d, dtype=torch.float32, device=msg.device)
    if n_rows == 0 or d == 0:
        return out
    # indptr[-1] <= E is asserted inside the kernel (a host check here would
    # synchronise the stream on every launch)
    kernels = load_kernels()
    with torch.cuda.device(msg.device):
        stream = torch.cuda.current_stream(msg.device).cuda_stream
        code = kernels.lib.kgc_segment_sum(
            msg.data_ptr(), int(msg.dtype == torch.bfloat16),
            indptr.data_ptr(), out.data_ptr(), n_rows, msg.shape[0], d,
            stream)
    check_launch(kernels.lib, code, "segment_sum")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
