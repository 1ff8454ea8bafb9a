"""Training losses (the port's ``kgc_gcn_tpu/ops/losses.py``): the dense
1-vs-all BCE (``loss_impl=dense``) and the negative-sampling objectives.

The reference computes ``BCELoss(sigmoid(x), y)`` (reference
model.py:22,179; main.py:62); the port keeps the logits and uses the stable
form, which is the same function:

    BCE(sigmoid(x), y) = max(x, 0) - x*y + log(1 + exp(-|x|))

Row masking serves the padded last batch: torch's mean is over all B*N
elements (main.py:62), so the masked mean divides by ``valid_rows * N``.
"""

from __future__ import annotations

from typing import Optional

import torch


class _BCEWithLogits(torch.autograd.Function):
    """Masked mean BCE with the JAX package's custom backward
    (``losses.py:37-47``): ``d_logits = (sigmoid(x) - y) * w / denom``."""

    @staticmethod
    def forward(ctx, logits, targets, row_mask):
        per = (logits.clamp_min(0.0) - logits * targets
               + torch.log1p(torch.exp(-logits.abs())))
        denom = row_mask.sum().clamp_min(1.0) * logits.shape[1]
        ctx.save_for_backward(logits, targets, row_mask, denom)
        return (per * row_mask[:, None]).sum() / denom

    @staticmethod
    def backward(ctx, g):
        logits, targets, row_mask, denom = ctx.saved_tensors
        scale = g / denom
        w = row_mask[:, None]
        d_logits = (torch.sigmoid(logits) - targets) * w * scale
        d_targets = -logits * w * scale
        return d_logits, d_targets, None


def bce_with_logits(logits: torch.Tensor,             # (B, N)
                    targets: torch.Tensor,            # (B, N) in [0, 1]
                    row_mask: Optional[torch.Tensor] = None,  # (B,) 1 / 0
                    ) -> torch.Tensor:
    if row_mask is None:
        row_mask = logits.new_ones(logits.shape[0])
    return _BCEWithLogits.apply(logits, targets, row_mask)


# ------------------------------------------------ negative-sampling objectives

def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)), as ``jax.nn.softplus`` computes it (logaddexp)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def margin_ranking_loss(pos_scores: torch.Tensor,   # (B,)
                        neg_scores: torch.Tensor,   # (B, K)
                        margin: float = 1.0,
                        row_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Hinge ``max(0, margin - s+ + s-)``, masked mean over valid rows x K
    (``kgc_gcn_tpu/ops/losses.py:63-75``)."""
    per = torch.relu(margin - pos_scores[:, None] + neg_scores)
    if row_mask is None:
        return per.mean()
    denom = row_mask.sum().clamp_min(1.0) * per.shape[1]
    return (per * row_mask[:, None]).sum() / denom


def self_adversarial_loss(pos_logits: torch.Tensor,   # (B,)
                          neg_logits: torch.Tensor,   # (B, K)
                          margin: float = 1.0,
                          temperature: float = 1.0,
                          row_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """RotatE's ``-log σ(γ + s+) - Σ_k p_k log σ(-s_k - γ)`` with the weights
    ``p = softmax(α s-)`` detached (``kgc_gcn_tpu/ops/losses.py:78-99``)."""
    w = torch.softmax(temperature * neg_logits, dim=1).detach()
    per = (_softplus(-(margin + pos_logits))
           + (w * _softplus(neg_logits + margin)).sum(dim=1))
    if row_mask is None:
        return per.mean()
    return (per * row_mask).sum() / row_mask.sum().clamp_min(1.0)


def sampled_bce_with_logits(pos_logits: torch.Tensor,   # (B,)
                            neg_logits: torch.Tensor,   # (B, K)
                            row_mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """BCE over one positive and K sampled negatives per query
    (``kgc_gcn_tpu/ops/losses.py:102-110``)."""
    logits = torch.cat([pos_logits[:, None], neg_logits], dim=1)
    targets = torch.zeros_like(logits)
    targets[:, 0] = 1.0
    return bce_with_logits(logits, targets, row_mask)
