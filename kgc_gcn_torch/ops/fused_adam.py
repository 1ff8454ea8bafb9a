"""The optimizer layer's fused step and its plain version.

``fused_adam(params, grads, state, cfg, lr, sharded, group)`` is
``train/optim.py:step``: optax's global-norm clip, ``g + wd * p`` and Adam,
then ``p += -lr * u``, in place, with the moments in float32 or bf16.  On
CUDA tensors it launches the hand-written multi-tensor kernel
``csrc/fused_adam.cu`` or raises; on CPU tensors it runs ``optim.step``.
There is no fallback from the card to the plain version.

One call is two CUDA launches whatever the number of leaves (pass A sums
the squares of the gradients into two device sums, pass B reads them and
updates every leaf once), or one with clipping off; a list of more leaves
than one launch's argument holds takes a pair per such group.  Under a
graph axis the sum of the sharded leaves' squares is summed over ``group``
between the passes, as ``optim.clip_by_global_norm`` does; the norm never
leaves the device.  The kernel's header states its bound.
``fused_adam.launches`` counts the kernel's calls (never the plain
version's).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from kgc_gcn_torch.config import Config
from kgc_gcn_torch.parallel.distributed import all_reduce_sum
from kgc_gcn_torch.train import optim
from kgc_gcn_torch.utils.cuda_build import check_launch, load_kernels

_MOMENT_DTYPES = (torch.float32, torch.bfloat16)
# per (device index, stream): pass A's block partials and two sums
# (float64), and its arrival counter (int32, kept 0 by the kernel)
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _check(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
           state: optim.AdamState, sharded: Sequence[bool]) -> None:
    n = len(params)
    if not (len(grads) == len(state.mu) == len(state.nu) == n):
        raise ValueError(f"{n} params, {len(grads)} grads, {len(state.mu)} "
                         f"and {len(state.nu)} moments")
    if len(sharded) not in (0, n):
        raise ValueError(f"sharded has {len(sharded)} flags for {n} leaves")
    if n == 0:
        return
    device = params[0].device
    mdtype = state.mu[0].dtype
    if mdtype not in _MOMENT_DTYPES:
        raise ValueError(f"moments must be float32 or bfloat16, got {mdtype}")
    for i, leaf in enumerate(zip(params, grads, state.mu, state.nu)):
        p, g, mu, nu = leaf
        if not (p.dtype == g.dtype == torch.float32):
            raise ValueError(f"leaf {i}: params and grads must be float32, "
                             f"got {p.dtype} / {g.dtype}")
        if not (mu.dtype == nu.dtype == mdtype):
            raise ValueError(f"leaf {i}: moments must all be {mdtype}, got "
                             f"{mu.dtype} / {nu.dtype}")
        if not (p.shape == g.shape == mu.shape == nu.shape):
            raise ValueError(f"leaf {i}: shapes {tuple(p.shape)}, "
                             f"{tuple(g.shape)}, {tuple(mu.shape)}, "
                             f"{tuple(nu.shape)} differ")
        if not all(t.device == device for t in leaf):
            raise ValueError(f"leaf {i}: every tensor must be on {device}")
        if not all(t.is_contiguous() for t in leaf):
            raise ValueError(f"leaf {i}: every tensor must be contiguous")


def _scratch(device: torch.device, stream: int,
             blocks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None:
        buf = (torch.empty(2 * blocks + 2, dtype=torch.float64, device=device),
               torch.zeros(1, dtype=torch.int32, device=device))
        _SCRATCH[key] = buf
    return buf


def _pointers(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def fused_adam(params: Sequence[torch.Tensor], grads: List[torch.Tensor],
               state: optim.AdamState, cfg: Config, lr: float,
               sharded: Sequence[bool] = (), group=None) -> None:
    """``optim.step`` (clip, decay, Adam, ``p -= lr * u``, in place) through
    the kernel on CUDA tensors; ``fused_adam.launches`` counts its calls."""
    _check(params, grads, state, sharded)
    if not params or params[0].device.type == "cpu":
        optim.step(params, grads, state, cfg, lr, sharded, group)
        return
    device = params[0].device
    if device.type != "cuda":
        raise ValueError(f"fused_adam runs on cpu or cuda, not {device}")
    clip = bool(cfg.clip_grad and cfg.clip_grad > 0)
    decay = cfg.weight_decay if cfg.weight_decay and cfg.weight_decay > 0 else 0.0
    state.count += 1
    lib = load_kernels().lib
    count = len(params)
    sizes = (ctypes.c_int64 * count)(*(p.numel() for p in params))
    g_ptrs = _pointers(grads)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        own = shard = None
        if clip:
            blocks = lib.kgc_fused_adam_norm_blocks()
            partials, arrivals = _scratch(device, stream, blocks)
            sums = partials[2 * blocks:]
            flags = (ctypes.c_uint8 * count)(
                *(bool(s) for s in sharded or [False] * count))
            code = lib.kgc_fused_adam_norm(
                g_ptrs, sizes, flags, count, partials.data_ptr(),
                arrivals.data_ptr(), sums.data_ptr(), stream)
            check_launch(lib, code, "fused_adam (norm)")
            own, shard = sums[:1], sums[1:]
            if group is not None and any(sharded):
                shard = all_reduce_sum(shard, group)
        code = lib.kgc_fused_adam_update(
            _pointers(params), g_ptrs, _pointers(state.mu),
            _pointers(state.nu), sizes, count,
            int(state.mu[0].dtype == torch.bfloat16),
            own.data_ptr() if clip else None,
            shard.data_ptr() if clip else None,
            float(cfg.clip_grad) if clip else 0.0, decay, optim.B1, optim.B2,
            1 - optim.B1, 1 - optim.B2,
            optim.bias_correction(optim.B1, state.count),
            optim.bias_correction(optim.B2, state.count), optim.EPS, -lr,
            stream)
    check_launch(lib, code, "fused_adam (update)")
    fused_adam.launches += 1


fused_adam.launches = 0
