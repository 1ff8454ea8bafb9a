"""The kernel wrappers a path runs, as one bundle.

``KERNELS`` holds the wrappers of the port's CUDA kernels (each runs its
kernel on a CUDA tensor and its plain version on a CPU tensor); ``PLAIN``
holds the plain PyTorch versions, which run on any device.  Models, trainers
and ``evaluate`` take a bundle, so one switch (``Trainer(plain=True)``) moves
a whole step onto the plain versions: the card's check of a kernel step
against the same step in plain PyTorch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from kgc_gcn_torch.ops.basis import (
    basis_backward, basis_backward_reference, basis_segment_sum,
    basis_segment_sum_reference)
from kgc_gcn_torch.ops.elementwise import (
    bwd_products, bwd_products_reference, compose_msg, compose_msg_reference)
from kgc_gcn_torch.ops.fused_compose import (
    fused_compose, fused_compose_reference)
from kgc_gcn_torch.ops.fused_loss import (
    dense_grads, dense_grads_reference, dense_loss, dense_loss_reference)
from kgc_gcn_torch.ops.segment_max import segment_max, segment_max_reference
from kgc_gcn_torch.ops.segment_sum import segment_sum, segment_sum_reference


@dataclass(frozen=True)
class Kernels:
    seg_sum: Callable        # K1
    dense_loss: Callable     # K2a
    dense_grads: Callable    # K2b
    basis_sum: Callable      # K7
    basis_bwd: Callable      # K8
    seg_max: Callable        # K5
    fused_compose: Callable  # K3
    compose_msg: Callable    # K4a
    bwd_products: Callable   # K4b


KERNELS = Kernels(segment_sum, dense_loss, dense_grads, basis_segment_sum,
                  basis_backward, segment_max, fused_compose, compose_msg,
                  bwd_products)
PLAIN = Kernels(segment_sum_reference, dense_loss_reference,
                dense_grads_reference, basis_segment_sum_reference,
                basis_backward_reference, segment_max_reference,
                fused_compose_reference, compose_msg_reference,
                bwd_products_reference)
