"""Sorted CSR segment-max: kernel K5 of the port and its plain version.

``segment_max(logits, dst, indptr, n_rows)`` computes, for (E, H) float32
logits whose destination ids ``dst`` are non-decreasing with CSR pointers
``indptr``,

    out[r] = max over indptr[r] <= e < indptr[r+1] of logits[e]    (float32)

with -inf for rows that have no edges — what
``kgc_gcn_tpu/ops/spmm_pallas.py:segment_max_sorted`` computes.  It is not
differentiable: its one caller, the RGAT segment softmax, feeds it detached
logits (the max subtraction's gradient is exactly zero).  On a CUDA tensor it
launches the hand-written kernel ``csrc/segment_max.cu`` or raises; on a CPU
tensor it runs the plain version.  There is no fallback from the card to the
plain version.

The kernel puts a warp's lanes over edges: warp k takes the
``SEGMENT_MAX_CHUNK`` edges from k * SEGMENT_MAX_CHUNK (4 consecutive ones a
lane),
closes each row by a segmented shuffle scan keyed on ``dst``, and writes the
rows whose first edge it holds, reading on past its chunk for a row of at
most ``SEGMENT_MAX_LIMIT`` edges (probes of ``dst`` ahead of the chunk find
the row's end, so most rows need no read of ``indptr``).  A longer row is
cut at the chunk boundaries; the last of its pieces to finish combines
them.  One launch a call, no host sync (``segment_max_schedule`` needs only
the shapes), and the output is the same bits on every call.  The kernel's
header states its bound, its NaN and +-0 rules and its scratch.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from kgc_gcn_torch.utils.cuda_build import check_launch, load_kernels

# The kernel's constants (``kC`` and ``kL`` in csrc/segment_max.cu): the
# edges a warp takes, 4 consecutive ones a lane, and the longest row whose
# owner reads on past its chunk (longer rows are cut into pieces at the
# chunk boundaries).
SEGMENT_MAX_CHUNK = 128
SEGMENT_MAX_LIMIT = 512


class SegmentMaxSchedule(NamedTuple):
    """K5's chunks and scratch, from the shape alone (no read of the
    graph)."""
    n_chunks: int          # E // SEGMENT_MAX_CHUNK + 1: position E has a warp
    partials_shape: tuple  # a hub piece's maxima, (n_chunks, 2, H) float32


def segment_max_schedule(e: int, h: int) -> SegmentMaxSchedule:
    """K5's schedule for E edges and H heads, as its launcher
    (``kgc_segment_max`` in csrc/segment_max.cu) expects it."""
    n_chunks = e // SEGMENT_MAX_CHUNK + 1
    return SegmentMaxSchedule(n_chunks, (n_chunks, 2, h))


# One zeroed int32 counter a row for each (device, stream): the kernel
# leaves it zero, and two launches that run at once never share one.
_ARRIVALS: Dict[Tuple[int, int], torch.Tensor] = {}


def arrival_counters(device: torch.device, stream: int,
                     n_rows: int) -> torch.Tensor:
    """The hub rows' arrival counters for launches on ``stream``: zeros,
    allocated once and grown (never shrunk) to ``n_rows``, so that no call
    pays a memset."""
    key = (device.index, stream)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < n_rows:
        buf = torch.zeros(n_rows, dtype=torch.int32, device=device)
        _ARRIVALS[key] = buf
    return buf


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
    if (e + 2 * (SEGMENT_MAX_CHUNK + SEGMENT_MAX_LIMIT) >= 2**31
            or n_rows * logits.shape[1] >= 2**31):
        raise ValueError("segment_max takes sizes below 2**31")


def segment_max(logits: torch.Tensor, dst: torch.Tensor, indptr: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """(E, H) float32 logits sorted by ``dst`` -> (n_rows, H) float32, -inf
    on empty rows.

    On the card one launch of K5 (``segment_max_schedule``; scratch: the
    hub pieces' partials, uninitialised, and the stream's arrival
    counters).  ``segment_max.launches`` counts the kernel launches (never
    the plain version's calls)."""
    _check(logits, dst, indptr, n_rows)
    if logits.device.type == "cpu":
        if n_rows and int(indptr[-1]) > logits.shape[0]:
            raise ValueError("indptr[-1] exceeds the edge count")
        return segment_max_reference(logits, dst, indptr, n_rows)
    if logits.device.type != "cuda":
        raise ValueError(f"segment_max runs on cpu or cuda, not {logits.device}")
    if not (logits.is_contiguous() and dst.is_contiguous()
            and indptr.is_contiguous()):
        raise ValueError("logits, dst and indptr must be contiguous")
    e, h = logits.shape
    out = torch.empty(n_rows, h, dtype=torch.float32, device=logits.device)
    if n_rows == 0 or h == 0:
        return out
    # indptr's ends and dst's range are asserted inside the kernel (a host
    # check here would synchronise the stream on every launch)
    sched = segment_max_schedule(e, h)
    partials = torch.empty(sched.partials_shape, dtype=torch.float32,
                           device=logits.device)
    kernels = load_kernels()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        arrivals = arrival_counters(logits.device, stream, n_rows)
        code = kernels.lib.kgc_segment_max(
            logits.data_ptr(), dst.data_ptr(), indptr.data_ptr(),
            out.data_ptr(), partials.data_ptr(), arrivals.data_ptr(), n_rows,
            e, h, stream)
    check_launch(kernels.lib, code, "segment_max")
    segment_max.launches += 1
    return out


segment_max.launches = 0
