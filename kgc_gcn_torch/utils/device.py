"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    ``cuda`` (the default) requires a card and raises without one: the port
    never drops back to the CPU on its own; ``cpu`` must be asked for.  Float32
    matrix products and convolutions are pinned to full float32 (no TF32)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch sees no CUDA device "
            "(pass --device cpu to run on the CPU)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device
