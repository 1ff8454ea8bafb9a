"""Shared model building blocks: initializers, BatchNorm, mixed matmul and
dropout (the port's ``kgc_gcn_tpu/models/common.py``).

  * ``xavier_uniform``: bound ``sqrt(6/(fan_in+fan_out))`` with torch's 2-D fan
    convention ``fan_in = shape[1], fan_out = shape[0]`` (reference
    utils.py:113-118).
  * BatchNorm: eps 1e-5, momentum 0.1; training normalizes with the BIASED
    batch variance and updates the running variance with the UNBIASED one;
    eval uses the running statistics (reference model.py:56,137-139).  Under
    a data axis the decoder's BatchNorms take their moments over the global
    batch (``group``), as the JAX package's GSPMD does.
  * dropout: inverted dropout ``where(keep, x / (1 - p), 0)``.
  * ``init_embeddings_from_npz``: warm-start tables (``--init_embeddings``).

Initializers and dropout masks draw from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from kgc_gcn_torch.parallel.distributed import all_reduce_sum, group_size


# ---------------------------------------------------------------- initializers

def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -bound, bound, generator=generator)


def xavier_uniform(shape: Tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
    fan_in = math.prod(shape[1:])
    fan_out = shape[0] * (math.prod(shape[2:]) if len(shape) > 2 else 1)
    return _uniform(shape, math.sqrt(6.0 / (fan_in + fan_out)), generator)


def kaiming_uniform_torch(shape: Tuple[int, ...],
                          generator: torch.Generator) -> torch.Tensor:
    """torch's default Linear/Conv2d weight init (kaiming_uniform, a=sqrt(5)):
    for weight shape (out, in, *rf), bound = 1/sqrt(fan_in)."""
    return _uniform(shape, 1.0 / math.sqrt(math.prod(shape[1:])), generator)


def fan_in_bias_uniform(size: int, fan_in: int,
                        generator: torch.Generator) -> torch.Tensor:
    return _uniform((size,), 1.0 / math.sqrt(fan_in), generator)


# ------------------------------------------------------------------- BatchNorm

def batch_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    *,
    train: bool,
    channel_axis: int = -1,
    momentum: float = 0.1,
    eps: float = 1e-5,
    group=None,
    row_mask: Optional[torch.Tensor] = None,
    n_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Functional BatchNorm over all axes except ``channel_axis``; returns
    (y, new running mean, new running var).  With a process ``group`` (the
    data group: each rank holds an equal slice of the batch) the moments are
    the global batch's, in two passes as in ``kgc_gcn_tpu/models/
    common.py:75-104``: the sum, then the sum of squared deviations from the
    global mean, each summed over the group (gradients summed back).  Rows
    of unequal slices (a rank's block of entity rows, the last one with
    padding rows) give ``row_mask`` (rows,), 1 on the rows that count, and
    ``n_rows``, the group's count of them."""
    axis = channel_axis % x.dim()
    axes = tuple(i for i in range(x.dim()) if i != axis)
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    if train:
        n = float(math.prod(x.shape[i] for i in axes))
        if group is None and row_mask is None:
            m = x.mean(dim=axes)
            v = (x - m.reshape(shape)).square().mean(dim=axes)
        else:
            w = 1.0 if row_mask is None else row_mask.reshape(
                (-1,) + (1,) * (x.dim() - 1))
            n = float(n_rows) if n_rows is not None else n * group_size(group)
            m = all_reduce_sum((x * w).sum(dim=axes), group) / n
            v = all_reduce_sum(((x - m.reshape(shape)).square() * w)
                               .sum(dim=axes), group) / n
        new_mean = (1 - momentum) * mean + momentum * m
        new_var = (1 - momentum) * var + momentum * v * (n / max(n - 1.0, 1.0))
    else:
        m, v, new_mean, new_var = mean, var, mean, var
    y = (x - m.reshape(shape)) * torch.rsqrt(v.reshape(shape) + eps)
    return y * scale.reshape(shape) + bias.reshape(shape), new_mean, new_var


class BatchNorm(nn.Module):
    """BatchNorm parameters ``scale``/``bias`` and running ``mean``/``var``
    under the JAX package's names (``BNParams``/``BNState``).

    ``forward(x)`` normalizes with the running statistics; ``forward(x,
    train=True)`` with the batch statistics, and then moves the running
    statistics in place, outside autograd."""

    def __init__(self, c: int, channel_axis: int = -1):
        super().__init__()
        self.channel_axis = channel_axis
        self.group = None   # the data group, where the batch is sharded
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor, train: bool = False,
                rows=None) -> torch.Tensor:
        """``rows`` (``parallel.entity_sharding.EntityRows``): ``x`` is a
        rank's block of entity rows; the moments are over the real rows of
        every rank's block, and scale and bias sum their gradients over the
        group."""
        scale, bias = self.scale, self.bias
        group, mask, n = self.group, None, None
        if rows is not None:
            scale, bias = rows.weights(scale, bias)
            group, mask, n = rows.group, rows.mask, rows.n_ent
        y, new_mean, new_var = batch_norm(
            x, scale, bias, self.mean, self.var, train=train,
            channel_axis=self.channel_axis, group=group, row_mask=mask,
            n_rows=n)
        if train:
            with torch.no_grad():
                self.mean.copy_(new_mean)
                self.var.copy_(new_var)
        return y


# ---------------------------------------------------------------- mixed matmul

def mm(a: torch.Tensor, b: torch.Tensor,
       compute_dtype: str = "float32") -> torch.Tensor:
    """``a @ b`` in float32; with ``compute_dtype='bfloat16'`` the operands
    are rounded to bf16 first and the products still accumulate in float32
    (the semantics of the JAX package's ``mm``)."""
    if compute_dtype == "bfloat16":
        a = a.to(torch.bfloat16).float()
        b = b.to(torch.bfloat16).float()
    return torch.matmul(a, b)


# --------------------------------------------------------------------- dropout

def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], train: bool) -> torch.Tensor:
    """Inverted dropout with the keep mask drawn from ``generator`` (which
    must live on ``x``'s device); the identity when not training, at rate 0
    or without a generator (``kgc_gcn_tpu/models/common.py:124-129``)."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


# ------------------------------------------------------------------ warm start

def init_embeddings_from_npz(model: nn.Module, path: str) -> None:
    """Warm-start the model's embedding tables from an ``.npz``, in place
    (``kgc_gcn_tpu/models/common.py:init_embeddings_from_npz``).

    Recognized keys: ``entity_embedding`` (N, gcn_in_dim) and
    ``relation_embedding`` (2R, d), the PARAMETER tables (not the encoder
    outputs that ``serve.Predictor.export_tables`` writes).  Shapes must
    match exactly, and at least one key must apply."""
    updates = {}
    with np.load(path, allow_pickle=False) as data:
        for key in ("entity_embedding", "relation_embedding"):
            if key not in data.files:
                continue
            if not hasattr(model, key):
                raise ValueError(f"{key!r} in {path} but this model family "
                                 "has no such parameter")
            cur = getattr(model, key)
            arr = np.asarray(data[key], np.float32)
            if arr.shape != tuple(cur.shape):
                raise ValueError(
                    f"{key} shape {arr.shape} != model shape "
                    f"{tuple(cur.shape)} (is this an export_tables file? "
                    "those hold ENCODED tables, not parameters)")
            updates[key] = arr
        if not updates:
            raise ValueError(
                f"{path} has none of entity_embedding/relation_embedding "
                f"(found: {sorted(data.files)})")
    with torch.no_grad():
        for key, arr in updates.items():
            getattr(model, key).copy_(torch.from_numpy(arr))
