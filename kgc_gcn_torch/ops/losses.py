"""The dense training loss (the port's ``kgc_gcn_tpu/ops/losses.py``,
``loss_impl=dense``).

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
