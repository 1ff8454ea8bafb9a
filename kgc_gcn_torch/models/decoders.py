"""Scoring decoders: ConvE and DistMult (the port's ``kgc_gcn_tpu/models/decoders.py``).

Each returns LOGITS over all entities; the reference's final sigmoid
(model.py:179) is monotonic, so ranking is unchanged.  Both have a query
trunk ``query`` with ``logits == h @ all_ent.T + ent_bias``, which the sparse
and fused losses and the candidate scoring of negative sampling use
(``models/family_base.py``).  ConvE's convolution keeps the JAX package's
im2col + matmul form rather than ``F.conv2d``, so it runs as a plain float32
matrix product and never through cuDNN's TF32 path.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from kgc_gcn_torch.config import Config
from kgc_gcn_torch.models.common import (
    BatchNorm, dropout, fan_in_bias_uniform, kaiming_uniform_torch, mm,
)


def conve_flat_size(cfg: Config) -> int:
    """(2*k_w - k + 1) * (k_h - k + 1) * num_filter (reference model.py:152-154)."""
    h = 2 * cfg.k_w - cfg.kernel_size + 1
    w = cfg.k_h - cfg.kernel_size + 1
    return h * w * cfg.num_filter


def _conv2d_c1_im2col(x: torch.Tensor, w: torch.Tensor,
                      compute_dtype: str) -> torch.Tensor:
    """VALID stride-1 conv for a SINGLE input channel as im2col + matmul.

    x: (B, 1, H, W); w: (F, 1, K, K) OIHW  ->  (B, F, H-K+1, W-K+1).
    The patch of output (p, q) lists x[p+i, q+j] with i major, j minor — the
    order of ``w.reshape(F, K*K)``."""
    b, _, hh, ww = x.shape
    f, _, k, _ = w.shape
    oh, ow = hh - k + 1, ww - k + 1
    cols = x[:, 0].unfold(1, k, 1).unfold(2, k, 1)       # (B, OH, OW, K, K)
    out = mm(cols.reshape(b * oh * ow, k * k), w.reshape(f, -1).T,
             compute_dtype)                              # (B*OH*OW, F)
    return out.reshape(b, oh, ow, f).permute(0, 3, 1, 2)


class ConvE(nn.Module):
    """ConvE parameters under the JAX package's ``ConvEParams`` names, with
    the running statistics of ``ConvEState`` as buffers of the BN modules.
    ``__init__``, ``query`` and ``forward`` are the JAX ``conve_init``,
    ``conve_query`` and ``conve_apply``."""

    def __init__(self, cfg: Config, n_ent: int, generator: torch.Generator):
        super().__init__()
        if 2 * cfg.k_w * cfg.k_h != 2 * cfg.gcn_out_dim:
            raise ValueError(
                f"ConvE reshape needs k_w*k_h == gcn_out_dim, got "
                f"{cfg.k_w}*{cfg.k_h} != {cfg.gcn_out_dim}")
        self.cfg = cfg
        k = cfg.kernel_size
        flat = conve_flat_size(cfg)
        self.bn0 = BatchNorm(1, channel_axis=1)
        self.conv_w = nn.Parameter(kaiming_uniform_torch(
            (cfg.num_filter, 1, k, k), generator))
        self.conv_b = (nn.Parameter(fan_in_bias_uniform(
            cfg.num_filter, k * k, generator)) if cfg.bias else None)
        self.bn1 = BatchNorm(cfg.num_filter, channel_axis=1)
        self.fc_w = nn.Parameter(kaiming_uniform_torch(
            (cfg.gcn_out_dim, flat), generator))
        self.fc_b = nn.Parameter(fan_in_bias_uniform(
            cfg.gcn_out_dim, flat, generator))
        self.bn2 = BatchNorm(cfg.gcn_out_dim)
        self.ent_bias = nn.Parameter(torch.zeros(n_ent))

    def query(self, src_emb: torch.Tensor, rel_emb: torch.Tensor,
              train: bool = False,
              rngs: Optional[Dict[str, torch.Generator]] = None
              ) -> torch.Tensor:
        """Decoder trunk: query vector h (B, gcn_out_dim).

        Reference model.py:159-175.  The image layout is the reference's:
        stack (B, 2, d), transpose to (B, d, 2) and reshape row-major to
        (B, 1, 2*k_w, k_h), i.e. src/rel features interleaved along rows.
        With ``train`` the three BNs use batch statistics (and move their
        running ones), ``feat`` dropout follows the conv's ReLU and
        ``hidden`` dropout the fc layer (``decoders.py:137-169``)."""
        cfg = self.cfg
        rngs = rngs or {}
        b = src_emb.shape[0]
        img = torch.stack([src_emb, rel_emb], dim=1).transpose(1, 2).reshape(
            b, 1, 2 * cfg.k_w, cfg.k_h)
        x = _conv2d_c1_im2col(self.bn0(img, train), self.conv_w,
                              cfg.compute_dtype)
        if self.conv_b is not None:
            x = x + self.conv_b[None, :, None, None]
        x = torch.relu(self.bn1(x, train))
        x = dropout(x, cfg.feat_drop, rngs.get("feat"), train)
        x = mm(x.reshape(b, -1), self.fc_w.T, cfg.compute_dtype) + self.fc_b
        x = dropout(x, cfg.hidden_drop, rngs.get("hidden"), train)
        return torch.relu(self.bn2(x, train))

    def forward(self, src_emb: torch.Tensor, rel_emb: torch.Tensor,
                all_ent: torch.Tensor, train: bool = False,
                rngs: Optional[Dict[str, torch.Generator]] = None
                ) -> torch.Tensor:
        """1-vs-all logits (B, N) = h @ all_ent.T + ent_bias
        (reference model.py:177-178)."""
        h = self.query(src_emb, rel_emb, train, rngs)
        return mm(h, all_ent.T, self.cfg.compute_dtype) + self.ent_bias[None, :]


class DistMult(nn.Module):
    """score(s, r, o) = <e_s * w_r, e_o> + b_o (``decoders.py:209-263,
    474-485``), with the JAX ``DistMultParams`` leaf ``ent_bias``
    (initialized to zeros); it has no state and ignores dropout keys."""

    def __init__(self, cfg: Config, n_ent: int):
        super().__init__()
        self.cfg = cfg
        self.ent_bias = nn.Parameter(torch.zeros(n_ent))

    def query(self, src_emb: torch.Tensor, rel_emb: torch.Tensor,
              train: bool = False,
              rngs: Optional[Dict[str, torch.Generator]] = None
              ) -> torch.Tensor:
        return src_emb * rel_emb

    def forward(self, src_emb: torch.Tensor, rel_emb: torch.Tensor,
                all_ent: torch.Tensor, train: bool = False,
                rngs: Optional[Dict[str, torch.Generator]] = None
                ) -> torch.Tensor:
        return (mm(src_emb * rel_emb, all_ent.T, self.cfg.compute_dtype)
                + self.ent_bias[None, :])
