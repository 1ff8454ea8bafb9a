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

The edge-partitioned paths use only the collectives gloo takes on CUDA
tensors: ``all_reduce`` with SUM and MAX, ``broadcast`` and ``all_gather``.
The entity-sharded schedules (``parallel/entity_sharding.py``) add
``reduce_scatter`` and ``send``/``recv``, which PyTorch's gloo takes on CPU
tensors only.  Where gloo carries a CUDA tensor (ranks sharing a card) the
two are staged explicitly, chosen from the backend and the tensor's device
and logged once: ``reduce_scatter`` is an ``all_reduce`` SUM and the rank's
slice, ``send``/``recv`` go through host memory.  NCCL (and gloo on the CPU)
runs ``reduce_scatter_tensor`` and ``batch_isend_irecv`` itself; NCCL's
branches need a card per rank and are unverified on a one-card machine.

The autograd functions below wrap them, one per rule of what a result
feeds:

  * ``reduce_from_group``: SUM forward, identity backward.  The result feeds
    work that is the same on every rank of the group (the aggregate going
    into the replicated combine, BatchNorm and decoder), so each rank's
    cotangent is already the whole one.
  * ``all_reduce_sum``: SUM forward, SUM backward.  The result feeds work
    that differs by rank (RGAT's softmax denominator, divided into each
    rank's own edges; BatchNorm's moments under a data axis or over entity
    rows), so each rank holds a part of the cotangent.
  * ``copy_to_group``: identity forward, SUM backward, for replicated inputs
    of per-shard work (the entity rows, the relation table, RGAT's attention
    vectors, the weights applied to a rank's entity rows): each rank's
    gradient is a partial, summed once.
  * ``all_gather_rows``: the group's row blocks in rank order forward,
    reduce-scatter backward (JAX's ``all_gather^T = psum_scatter``): the
    gathered rows feed per-shard work.
  * ``reduce_scatter_rows``: SUM and keep this rank's row block forward,
    all_gather backward (``psum_scatter^T = all_gather``).
  * ``gather_from_group``: all_gather forward, this rank's row block of the
    cotangent backward, not summed: the gathered rows feed work that is the
    same on every rank (the decoder).
  * ``scatter_to_group``: this rank's row block of a replicated tensor
    forward, all_gather backward, so that the replicated leaf's gradient is
    whole on every rank.
  * ``ppermute``: each tensor sent ``shift`` ranks on around the group and
    the one from ``shift`` ranks back received, all in one batch; the
    backward sends the cotangents the other way.
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


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


_LOGGED = set()


def _staged(t: torch.Tensor, group, what: str) -> bool:
    """Whether gloo carries this CUDA tensor, which its ``reduce_scatter``
    and ``send``/``recv`` do not take: the collective is then staged (logged
    once per kind)."""
    staged = t.device.type == "cuda" and dist.get_backend(group) == "gloo"
    if staged and what not in _LOGGED:
        _LOGGED.add(what)
        logging.info("gloo on CUDA tensors: %s is staged (%s)", what,
                     "an all_reduce SUM and this rank's rows"
                     if what == "reduce_scatter" else "through host memory")
    return staged


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


def _scatter_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The group's SUM of (G·r, ...) tensors, this rank's r rows."""
    t = t.detach().contiguous()
    rows = t.shape[0] // group_size(group)
    if _staged(t, group, "reduce_scatter"):
        lo = group_rank(group) * rows
        return _sum_(t.clone(), group)[lo:lo + rows].clone()
    out = t.new_empty((rows,) + t.shape[1:])
    dist.reduce_scatter_tensor(out, t, group=group)
    return out


def _own_rows(t: torch.Tensor, group) -> torch.Tensor:
    rows = t.shape[0] // group_size(group)
    lo = group_rank(group) * rows
    return t[lo:lo + rows]


def _permute(tensors: Sequence[torch.Tensor], shifts: Sequence[int],
             group) -> List[torch.Tensor]:
    """Each tensor sent to the rank ``shift`` on (mod G) and the one of the
    same shape from the rank ``shift`` back received, in one batch."""
    if not tensors:
        return []
    g, r = group_size(group), group_rank(group)
    staged = _staged(tensors[0], group, "send/recv")
    ops, recvs = [], []
    for t, shift in zip(tensors, shifts):
        t = t.detach().contiguous()
        if staged:
            t = t.cpu()
        recv = torch.empty_like(t)
        to = dist.get_global_rank(group, (r + shift) % g)
        frm = dist.get_global_rank(group, (r - shift) % g)
        # each shift in a batch has its own peer pair; its tag keeps them
        # apart all the same
        ops += [dist.P2POp(dist.isend, t, to, group, tag=shift % g),
                dist.P2POp(dist.irecv, recv, frm, group, tag=shift % g)]
        recvs.append(recv)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    dev = tensors[0].device
    return [x.to(dev) for x in recvs] if staged else recvs


class _AllGatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_gather_cat(t, group, 0)

    @staticmethod
    def backward(ctx, g):
        return _scatter_rows(g, ctx.group), None


class _ReduceScatterRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _scatter_rows(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, 0), None


class _GatherFromGroup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_gather_cat(t, group, 0)

    @staticmethod
    def backward(ctx, g):
        return _own_rows(g, ctx.group), None


class _ScatterToGroup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _own_rows(t, group).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, 0), None


class _PPermute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, group, shifts, *tensors):
        ctx.group, ctx.shifts = group, shifts
        return tuple(_permute(tensors, shifts, group))

    @staticmethod
    def backward(ctx, *grads):
        # unused outputs come as zeros (autograd materializes them)
        return (None, None, *_permute(grads, [-s for s in ctx.shifts],
                                      ctx.group))


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


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The group's row blocks in rank order; the backward reduce-scatters
    the cotangent (each rank's gathered rows feed its own work)."""
    return t if group is None else _AllGatherRows.apply(t, group)


def reduce_scatter_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The SUM over ``group``, this rank's block of ``rows / G`` rows; the
    backward all_gathers the cotangent."""
    return t if group is None else _ReduceScatterRows.apply(t, group)


def gather_from_group(t: torch.Tensor, group) -> torch.Tensor:
    """The group's row blocks in rank order; the backward keeps this rank's
    block of the cotangent, not summed (the result feeds work that is the
    same on every rank)."""
    return t if group is None else _GatherFromGroup.apply(t, group)


def scatter_to_group(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of ``rows / G`` rows of a replicated tensor; the
    backward all_gathers the cotangent, so the replicated leaf's gradient
    is whole on every rank."""
    return t if group is None else _ScatterToGroup.apply(t, group)


def ppermute(tensors: Sequence[torch.Tensor], shifts: Sequence[int],
             group) -> List[torch.Tensor]:
    """Each ``tensors[j]`` sent ``shifts[j]`` ranks on around ``group`` (the
    rank ``(r + shift) mod G``), and the tensor of its shape from ``shift``
    ranks back received, every transfer issued in one batch; the backward
    sends the cotangents back (``ppermute^T`` is the inverse shift)."""
    if group is None or not tensors:
        return list(tensors)
    return list(_PPermute.apply(group, tuple(shifts), *tensors))
