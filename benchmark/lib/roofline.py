"""Peaks of the card and the least time of a kernel call (its roofline).

A call's bound is the larger of its bytes at the memory rate and its
operations at the float32 rate outside the tensor cores: each input byte
read once and each output byte written once, whatever the kernel reads
again.  The byte and operation counts of K1, K7 and K8 are frozen copies of
``chip_smoke.py``'s ``bound``, ``basis_sum_bound`` and ``basis_bwd_bound``.
Peaks are NVIDIA's data sheet values of the SXM part at its 700 W limit; a
card set below that limit is stated beside every share.
"""

from __future__ import annotations

from typing import Optional

# card name (torch.cuda.get_device_name) -> peaks
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "bytes_per_s": 3.35e12},
}


def peaks(card: str) -> Optional[dict]:
    return PEAKS.get(card)


def bound_s(card: str, nbytes: float, ops: float) -> Optional[float]:
    p = peaks(card)
    if p is None:
        return None
    return max(nbytes / p["bytes_per_s"], ops / p["fp32_flops"])


def k1(e: int, n_rows: int, d: int, msg_bytes: int = 4):
    """Segment-sum (K1): each message, indptr entry and output element
    moved once; one add per message element.  -> (bytes, ops)"""
    return e * d * msg_bytes + 4 * (n_rows + 1) + 4 * n_rows * d, e * d


def k7(e: int, n_rows: int, d: int, nb: int):
    """K7: msg, a and indptr read once, out (n_rows, B*d) written once;
    2*E*B*d operations."""
    return (4 * (e * d + e * nb + n_rows + 1 + n_rows * nb * d),
            2.0 * e * nb * d)


def k8(e: int, rows: int, d: int, nb: int):
    """K8: dst, msg and a read once, g read once for each of the ``rows``
    rows that have edges, d_msg and d_a written once; 4*E*B*d
    operations."""
    return (4 * (rows * nb * d + 2 * e * d + 2 * e * nb + e),
            4.0 * e * nb * d)
