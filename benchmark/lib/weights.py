"""Initial weights made from the seed on the device, in one draw.

A configuration's reference module lists its leaves as ``Leaf`` specs; the
benchmark draws one uniform block for all of them with a ``torch.Generator``
on the device and maps each leaf's slice onto its range.  The same seed gives
the same weights, so the program and the reference each get them from the
benchmark, and neither takes them from the other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch


@dataclass(frozen=True)
class Leaf:
    """A named tensor drawn uniformly from [lo, hi) (``lo == hi``: the
    constant)."""

    name: str
    shape: Tuple[int, ...]
    lo: float
    hi: float


def xavier(name: str, shape: Tuple[int, ...], fan_in: int,
           fan_out: int) -> Leaf:
    b = (6.0 / (fan_in + fan_out)) ** 0.5
    return Leaf(name, tuple(shape), -b, b)


def make(leaves: List[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    """``{name: float32 tensor}`` on ``device``: one uniform draw of every
    leaf's elements, then each slice scaled onto its range."""
    sizes = [int(torch.Size(leaf.shape).numel()) for leaf in leaves]
    gen = torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + 1) % 2**63)
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, lo = {}, 0
    for leaf, n in zip(leaves, sizes):
        part = u[lo:lo + n].view(leaf.shape)
        out[leaf.name] = part * (leaf.hi - leaf.lo) + leaf.lo
        lo += n
    return out
