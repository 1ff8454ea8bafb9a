"""Optimizer: global-norm clipping, weight decay, Adam and the per-epoch
learning rate (the port's ``kgc_gcn_tpu/train/optim.py``).

The update of one step is the JAX package's optax chain, as plain tensor
functions over the parameter list:

  1. ``clip_by_global_norm``: ``g * max_norm / norm`` when ``norm >= max_norm``
     (optax's rule; ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm
     and is not used);
  2. ``g + weight_decay * p`` when weight decay is on;
  3. Adam(0.9, 0.999, eps 1e-8) with moments stored in float32 or, with
     ``moment_dtype=bfloat16``, in bf16 with float32 moment arithmetic
     (``optim.py:21-57``);
  4. ``p += -lr * u`` with the epoch's ``epoch_lr``.

Parameters and moments are updated in place; the state is
``AdamState(count, mu, nu)`` in the order of the parameter list, which is the
JAX leaf order (``convert.jax_leaf_names``), so it round-trips through the
JAX package's checkpoints.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from kgc_gcn_torch.config import Config

B1, B2, EPS = 0.9, 0.999, 1e-8
_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class AdamState:
    """optax ``ScaleByAdamState``: the step count and the two moments."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def moment_dtype(cfg: Config) -> torch.dtype:
    return _MOMENT_DTYPES[cfg.moment_dtype]


def init_state(params: Sequence[torch.Tensor], cfg: Config) -> AdamState:
    zeros = lambda: [torch.zeros_like(p, dtype=moment_dtype(cfg))
                     for p in params]
    return AdamState(0, zeros(), zeros())


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """optax's rule: unchanged below ``max_norm``, else ``(g / norm) *
    max_norm``.  The norm stays on the device (no host sync)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def step(params: Sequence[torch.Tensor], grads: List[torch.Tensor],
         state: AdamState, cfg: Config, lr: float) -> None:
    """One optimizer step: clip, decay, Adam, ``p -= lr * u``, in place."""
    if cfg.clip_grad and cfg.clip_grad > 0:
        grads = clip_by_global_norm(grads, cfg.clip_grad)
    if cfg.weight_decay and cfg.weight_decay > 0:
        grads = [g + cfg.weight_decay * p for g, p in zip(grads, params)]
    state.count += 1
    bc1 = _bias_correction(B1, state.count)
    bc2 = _bias_correction(B2, state.count)
    with torch.no_grad():
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            m = (1 - B1) * g + B1 * mu.float()
            v = (1 - B2) * (g * g) + B2 * nu.float()
            u = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
            mu.copy_(m)
            nu.copy_(v)
            p.add_(-lr * u)


def epoch_lr(cfg: Config, epoch: int) -> float:
    """lr for epoch (1-based), per ``cfg.lr_schedule``, after an optional
    linear warmup over ``warmup_epochs``: ``step`` is torch's StepLR stepped
    after each epoch, ``base * gamma ** ((epoch - 1) // step_size)``
    (reference main.py:152,219); ``cosine`` a half-cosine from base to 0 over
    ``max_epoch``; ``constant`` the base."""
    base = cfg.learning_rate
    warm = cfg.warmup_epochs
    if warm > 0 and epoch <= warm:
        return base * epoch / warm
    if cfg.lr_schedule == "constant":
        return base
    if cfg.lr_schedule == "cosine":
        t = (epoch - warm - 1) / max(cfg.max_epoch - warm, 1)
        return base * 0.5 * (1.0 + math.cos(math.pi * min(t, 1.0)))
    return base * cfg.lr_gamma ** ((epoch - 1) // cfg.lr_step_size)
