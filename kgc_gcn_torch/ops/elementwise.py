"""One-pass elementwise passes of the MGCN aggregation (``ew_impl=pallas``):
kernels K4a and K4b of the port and their plain versions.

``compose_msg(xgn, rg, etab, out_dtype)`` is the forward's per-edge message
``xgn * rg * etab``; ``bwd_products(gdn, xg, rg, etab, out_dtype)`` the
backward's three cotangent products ``(gdn*rg*etab, (gdn*xg)*etab,
(gdn*xg)*rg)``, of which the last, the edge table's gradient, stays float32.
All operands are (E, d) float32; they are what
``kgc_gcn_tpu/ops/elementwise_pallas.py:compose_msg_pad`` and
``bwd_products`` compute, without the TPU's 128-lane output padding.  On
CUDA tensors each launches its hand-written kernel (``csrc/elementwise.cu``:
one streaming pass, float4 loads; its header states the bound) or raises;
on CPU tensors it runs the plain version.  There is no fallback from the card
to the plain version, whatever E and d are.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kgc_gcn_torch.utils.cuda_build import check_launch, load_kernels

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def compose_msg_reference(xgn: torch.Tensor, rg: torch.Tensor,
                          etab: torch.Tensor,
                          out_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """Plain version of K4a: ``(xgn * rg) * etab`` in float32, then cast."""
    return (xgn * rg * etab).to(out_dtype)


def bwd_products_reference(gdn: torch.Tensor, xg: torch.Tensor,
                           rg: torch.Tensor, etab: torch.Tensor,
                           out_dtype: torch.dtype = torch.float32
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K4b: ``(contrib, d_rel_in, d_etab)``, the first two
    cast to ``out_dtype``, ``d_etab`` float32."""
    gx = gdn * xg
    return ((gdn * rg * etab).to(out_dtype), (gx * etab).to(out_dtype),
            gx * rg)


def _check(arrays, out_dtype, what: str) -> None:
    shape, device = arrays[0].shape, arrays[0].device
    for a in arrays:
        if a.dim() != 2 or a.dtype != torch.float32 or a.shape != shape:
            raise ValueError(f"{what} takes (E, d) float32 operands of one "
                             f"shape, got {tuple(a.shape)} {a.dtype}")
        if a.device != device:
            raise ValueError(f"{what}: operands must be on one device")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"{what}: out_dtype must be float32 or bfloat16, "
                         f"got {out_dtype}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {device}")
    if device.type == "cuda" and not all(a.is_contiguous() for a in arrays):
        raise ValueError(f"{what}: operands must be contiguous")


def _launch(name: str, *args) -> None:
    kernels = load_kernels()
    code = getattr(kernels.lib, name)(*args)
    check_launch(kernels.lib, code, name)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def compose_msg(xgn: torch.Tensor, rg: torch.Tensor, etab: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(E, d) float32 operands -> ``xgn * rg * etab`` (E, d) in
    ``out_dtype``.  ``compose_msg.launches`` counts the kernel launches."""
    _check((xgn, rg, etab), out_dtype, "compose_msg")
    if xgn.device.type == "cpu":
        return compose_msg_reference(xgn, rg, etab, out_dtype)
    out = torch.empty(xgn.shape, dtype=out_dtype, device=xgn.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(xgn.device):
        _launch("kgc_compose_msg", xgn.data_ptr(), rg.data_ptr(),
                etab.data_ptr(), out.data_ptr(),
                int(out_dtype == torch.bfloat16), out.numel(), _stream(xgn))
    compose_msg.launches += 1
    return out


def bwd_products(gdn: torch.Tensor, xg: torch.Tensor, rg: torch.Tensor,
                 etab: torch.Tensor, out_dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(E, d) float32 operands -> ``(contrib, d_rel_in, d_etab)``: the
    first two in ``out_dtype``, ``d_etab`` float32.
    ``bwd_products.launches`` counts the kernel launches."""
    _check((gdn, xg, rg, etab), out_dtype, "bwd_products")
    if gdn.device.type == "cpu":
        return bwd_products_reference(gdn, xg, rg, etab, out_dtype)
    contrib = torch.empty(gdn.shape, dtype=out_dtype, device=gdn.device)
    d_rel_in = torch.empty_like(contrib)
    d_etab = torch.empty(gdn.shape, dtype=torch.float32, device=gdn.device)
    if gdn.numel() == 0:
        return contrib, d_rel_in, d_etab
    with torch.cuda.device(gdn.device):
        _launch("kgc_bwd_products", gdn.data_ptr(), xg.data_ptr(),
                rg.data_ptr(), etab.data_ptr(), contrib.data_ptr(),
                d_rel_in.data_ptr(), d_etab.data_ptr(),
                int(out_dtype == torch.bfloat16), gdn.numel(), _stream(gdn))
    bwd_products.launches += 1
    return contrib, d_rel_in, d_etab


compose_msg.launches = 0
bwd_products.launches = 0
