"""Process set-up and the collectives of the port's multi-GPU path (the
counterpart of ``kgc_gcn_tpu/parallel/distributed.py``).

The JAX package runs one process per host and a device mesh inside it; the
port runs one process per rank, on ``torch.distributed``.  A launcher
(``torchrun``, or a script that sets the same variables) gives each process
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``
(``LOCAL_WORLD_SIZE`` too; without it every rank is taken to be local).
``maybe_initialize`` reads them, as the JAX version reads
``JAX_COORDINATOR_ADDRESS``, and is a no-op without them.

Rank -> device: ``cuda:(LOCAL_RANK % device_count)``, or the CPU when asked
for.  The backend follows from that topology, never from a failed attempt:

  * NCCL where every local rank has a card of its own;
  * gloo where local ranks share a card (gloo carries CUDA tensors through
    the host; the card check runs two ranks on one H100 so), and on the CPU.

The paths use only the collectives gloo takes on CUDA tensors:
``all_reduce`` with SUM and MAX, ``broadcast`` and ``all_gather``.

The autograd functions below wrap them for the edge-partitioned encoder
(``parallel/edge_parallel.py``, ``models/rgat.py``), one per rule of what a
result feeds:

  * ``reduce_from_group``: SUM forward, identity backward.  The result feeds
    work that is the same on every rank of the group (the aggregate going
    into the replicated combine, BatchNorm and decoder), so each rank's
    cotangent is already the whole one.
  * ``all_reduce_sum``: SUM forward, SUM backward.  The result feeds work
    that differs by rank (RGAT's softmax denominator, divided into each
    rank's own edges; BatchNorm's batch moments under a data axis), so each
    rank holds a part of the cotangent.
  * ``copy_to_group``: identity forward, SUM backward, for replicated inputs
    of per-shard work (the entity rows, the relation table, RGAT's attention
    vectors): each rank's gradient is a partial, summed once.
A ``group`` of None (one rank) makes each of them the identity.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

_STATE: Optional["DistInfo"] = None


@dataclass(frozen=True)
class DistInfo:
    rank: int
    world_size: int
    local_rank: int
    device: torch.device
    backend: str


def launcher_env() -> bool:
    """Whether a launcher configured a process group."""
    return all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT",
                                         "WORLD_SIZE", "RANK"))


def choose_backend(device: torch.device, local_world_size: int,
                   device_count: int) -> str:
    """``nccl`` where each local rank has a card of its own, else ``gloo``
    (on the CPU, or with ranks sharing a card)."""
    if device.type == "cuda" and local_world_size <= device_count:
        return "nccl"
    return "gloo"


def maybe_initialize(device: str = "cuda") -> Optional[DistInfo]:
    """Join the process group the launcher configured; None without one.
    Idempotent.  ``device`` is ``cuda`` (each rank takes the card
    ``LOCAL_RANK % device_count``) or ``cpu``."""
    global _STATE
    if _STATE is not None:
        return _STATE
    if not launcher_env():
        return None
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device == "cpu":
        dev, count = torch.device("cpu"), 0
    elif device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda requested but torch sees no "
                               "CUDA device (pass --device cpu)")
        count = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
    else:
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    backend = choose_backend(dev, local_world, count)
    addr, port = os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            world_size=world, rank=rank)
    _STATE = DistInfo(rank, world, local_rank, dev, backend)
    logging.info(
        "torch.distributed: rank %d/%d on %s, backend %s (%d local rank(s), "
        "%d card(s)%s)", rank, world, dev, backend, local_world, count,
        "; ranks share a card" if backend == "gloo" and count else "")
    return _STATE


def shutdown() -> None:
    """Leave the process group (the end of a run)."""
    global _STATE
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE = None


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


# ---------------------------------------------------------------- collectives

def _sum_(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def flat_all_reduce(tensors: Sequence[torch.Tensor],
                    group) -> List[torch.Tensor]:
    """SUM a list of float32 tensors over ``group`` in one collective:
    flattened into one buffer, reduced, and cut back into new tensors."""
    if group is None or not tensors:
        return list(tensors)
    flat = _sum_(torch.cat([t.reshape(-1).float() for t in tensors]), group)
    out, lo = [], 0
    for t in tensors:
        out.append(flat[lo:lo + t.numel()].view(t.shape).to(t.dtype))
        lo += t.numel()
    return out


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """MAX over ``group`` (a new tensor; no gradient)."""
    if group is None:
        return t
    t = t.detach().clone().contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors of equal shape, concatenated along ``dim`` in
    rank order (no gradient)."""
    if group is None:
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


class _ReduceFromGroup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, group):
        return _sum_(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _sum_(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _sum_(g.clone(), ctx.group), None


class _CopyToGroup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(s, dtype=dt, device=dev) if g is None else g
                 for g, (s, dt, dev) in zip(grads, ctx.shapes)]
        return (None, *flat_all_reduce(grads, ctx.group))


def reduce_from_group(t: torch.Tensor, group) -> torch.Tensor:
    """SUM over ``group``; the backward passes the cotangent through."""
    return t if group is None else _ReduceFromGroup.apply(t, group)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """SUM over ``group``; the backward sums the cotangents over it too."""
    return t if group is None else _AllReduceSum.apply(t, group)


def copy_to_group(group, *tensors: torch.Tensor) -> tuple:
    """The tensors unchanged; the backward sums their gradients over
    ``group`` (in one collective)."""
    if group is None:
        return tensors
    return _CopyToGroup.apply(group, *tensors)
