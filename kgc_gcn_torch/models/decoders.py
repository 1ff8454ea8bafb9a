"""Scoring decoders: ConvE, DistMult, TransE, ComplEx and RotatE (the port's
``kgc_gcn_tpu/models/decoders.py``).

Each returns LOGITS over all entities (``forward``); the reference's final
sigmoid (model.py:179) is monotonic, so ranking is unchanged.  Each scores
sampled candidates (``score_candidates``) for negative sampling, as the JAX
``CANDIDATE_SCORERS`` do.  ConvE, DistMult and ComplEx have a query trunk
``query`` with ``logits == h @ all_ent.T + ent_bias``, which the sparse and
fused losses use (``models/family_base.py``; the JAX ``QUERY_TRUNKS``);
TransE and RotatE are distance-based and have none (``has_trunk``).  ConvE's
convolution keeps the JAX package's im2col + matmul form rather than
``F.conv2d``, so it runs as a plain float32 matrix product and never through
cuDNN's TF32 path.  ``build_decoder`` is the counterpart of ``DECODERS``.
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


class _Decoder(nn.Module):
    """The leaf every decoder has, ``ent_bias`` (N,), initialized to zeros,
    and candidate scoring through the query trunk: the candidates' columns
    of ``h @ all_ent.T + ent_bias`` (``decoders.py:191-207,248-263,
    408-424``).  Decoders without a trunk override ``score_candidates``."""

    has_trunk = True

    def __init__(self, cfg: Config, n_ent: int,
                 generator: Optional[torch.Generator] = None):
        # ``generator``: the initial weights' source (``build_decoder``);
        # only ConvE draws any
        super().__init__()
        self.cfg = cfg
        self.ent_bias = nn.Parameter(torch.zeros(n_ent))

    def score_candidates(self, src_emb: torch.Tensor, rel_emb: torch.Tensor,
                         cand_emb: torch.Tensor, cand: torch.Tensor,
                         train: bool = False,
                         rngs: Optional[Dict[str, torch.Generator]] = None
                         ) -> torch.Tensor:
        """(B, d) queries and (B, K, d) candidates -> (B, K) logits."""
        h = self.query(src_emb, rel_emb, train, rngs)
        return torch.einsum("bd,bkd->bk", h, cand_emb) + self.ent_bias[cand]

    def forward(self, src_emb: torch.Tensor, rel_emb: torch.Tensor,
                all_ent: torch.Tensor, train: bool = False,
                rngs: Optional[Dict[str, torch.Generator]] = None
                ) -> torch.Tensor:
        """1-vs-all logits (B, N) = h @ all_ent.T + ent_bias."""
        h = self.query(src_emb, rel_emb, train, rngs)
        return mm(h, all_ent.T, self.cfg.compute_dtype) + self.ent_bias[None, :]


class ConvE(_Decoder):
    """ConvE parameters under the JAX package's ``ConvEParams`` names, with
    the running statistics of ``ConvEState`` as buffers of the BN modules.
    ``__init__``, ``query`` and ``forward`` are the JAX ``conve_init``,
    ``conve_query`` and ``conve_apply``."""

    def __init__(self, cfg: Config, n_ent: int, generator: torch.Generator):
        if 2 * cfg.k_w * cfg.k_h != 2 * cfg.gcn_out_dim:
            raise ValueError(
                f"ConvE reshape needs k_w*k_h == gcn_out_dim, got "
                f"{cfg.k_w}*{cfg.k_h} != {cfg.gcn_out_dim}")
        super().__init__(cfg, n_ent)
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


class DistMult(_Decoder):
    """score(s, r, o) = <e_s * w_r, e_o> + b_o (``decoders.py:209-263,
    474-485``); it has no state and ignores dropout keys."""

    def query(self, src_emb: torch.Tensor, rel_emb: torch.Tensor,
              train: bool = False,
              rngs: Optional[Dict[str, torch.Generator]] = None
              ) -> torch.Tensor:
        return src_emb * rel_emb


class ComplEx(_Decoder):
    """Re(<s, r, conj(o)>) + b_o with d_out split into (re | im) halves
    (``decoders.py:318-381,448-458``): the trunk is the complex product
    ``s * r``, scored as a real inner product with ``(o_re | o_im)``."""

    def __init__(self, cfg: Config, n_ent: int, generator=None):
        if cfg.gcn_out_dim % 2:
            raise ValueError("ComplEx needs an even gcn_out_dim (re/im "
                             f"split), got {cfg.gcn_out_dim}")
        super().__init__(cfg, n_ent)

    def query(self, src_emb: torch.Tensor, rel_emb: torch.Tensor,
              train: bool = False,
              rngs: Optional[Dict[str, torch.Generator]] = None
              ) -> torch.Tensor:
        """``_complex_query_vec``: h_re = s_re*r_re - s_im*r_im,
        h_im = s_re*r_im + s_im*r_re."""
        d = src_emb.shape[1] // 2
        s_re, s_im = src_emb[:, :d], src_emb[:, d:]
        r_re, r_im = rel_emb[:, :d], rel_emb[:, d:]
        return torch.cat([s_re * r_re - s_im * r_im,
                          s_re * r_im + s_im * r_re], dim=1)


class TransE(_Decoder):
    """score(s, r, o) = -||e_s + w_r - e_o||^2 + b_o (``decoders.py:266-315``).
    Distance-based: ``forward`` is the matmul form
    ``2 q·e_o - ||q||^2 - ||e_o||^2 + b_o`` with ``q = e_s + w_r``; there is
    no query trunk, so 1-vs-all training takes the dense loss."""

    has_trunk = False

    def point(self, src_emb: torch.Tensor, rel_emb: torch.Tensor
              ) -> torch.Tensor:
        """The translated subject q (B, d) that is compared with e_o."""
        return src_emb + rel_emb

    def forward(self, src_emb: torch.Tensor, rel_emb: torch.Tensor,
                all_ent: torch.Tensor, train: bool = False,
                rngs: Optional[Dict[str, torch.Generator]] = None
                ) -> torch.Tensor:
        q = self.point(src_emb, rel_emb)                         # (B, d)
        cross = mm(q, all_ent.T, self.cfg.compute_dtype)         # (B, N)
        q2 = torch.sum(q * q, dim=1, keepdim=True)               # (B, 1)
        o2 = torch.sum(all_ent * all_ent, dim=1)[None, :]        # (1, N)
        return 2.0 * cross - q2 - o2 + self.ent_bias[None, :]

    def score_candidates(self, src_emb: torch.Tensor, rel_emb: torch.Tensor,
                         cand_emb: torch.Tensor, cand: torch.Tensor,
                         train: bool = False,
                         rngs: Optional[Dict[str, torch.Generator]] = None
                         ) -> torch.Tensor:
        """-||q - e_k||^2 + b_k, as a (B, K, d) difference."""
        diff = self.point(src_emb, rel_emb)[:, None, :] - cand_emb
        return -torch.sum(diff * diff, dim=-1) + self.ent_bias[cand]


class RotatE(TransE):
    """score(s, r, o) = -||s ∘ e^{iθ} - e_o||^2 + b_o (``decoders.py:384-
    437``): the subject's (re | im) halves rotated by phases θ, the first
    d/2 dims of the relation output; TransE's matmul form and candidate
    scoring on that point."""

    def __init__(self, cfg: Config, n_ent: int, generator=None):
        if cfg.gcn_out_dim % 2:
            raise ValueError("RotatE needs an even gcn_out_dim (re/im "
                             f"split), got {cfg.gcn_out_dim}")
        super().__init__(cfg, n_ent)

    def point(self, src_emb: torch.Tensor, rel_emb: torch.Tensor
              ) -> torch.Tensor:
        """``_rotate_query_vec``."""
        d = src_emb.shape[1] // 2
        s_re, s_im = src_emb[:, :d], src_emb[:, d:]
        theta = rel_emb[:, :d]
        c, s = torch.cos(theta), torch.sin(theta)
        return torch.cat([s_re * c - s_im * s, s_re * s + s_im * c], dim=1)


DECODERS = {"conve": ConvE, "distmult": DistMult, "transe": TransE,
            "complex": ComplEx, "rotate": RotatE}


def build_decoder(cfg: Config, n_ent: int,
                  generator: torch.Generator) -> _Decoder:
    """The decoder ``cfg.decoder`` names (``decoders.py:DECODERS``); ConvE
    draws its initial weights from ``generator``, the others start from a
    zero entity bias."""
    if cfg.decoder not in DECODERS:
        raise ValueError(f"unknown decoder {cfg.decoder!r}; valid: "
                         + " | ".join(DECODERS))
    return DECODERS[cfg.decoder](cfg, n_ent, generator)
