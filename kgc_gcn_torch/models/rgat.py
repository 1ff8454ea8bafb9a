"""Relational graph attention (RGAT) + a decoder (the port's
``kgc_gcn_tpu/models/rgat.py`` on one device, on its kernel path).

Per layer and direction half, with H heads of ``dh = d_out / H``:

  * ``h = x @ weight``; the edge message ``z = h[src] * rel_mult[rel]``
    (``ops/sorted_ops.py:edge_compose``, shared by the logits and the
    aggregation, so both paths' cotangents meet in one backward);
  * logits ``s = leakyrelu(<z, att_src> + <h[dst], att_dst> + rel_bias[rel])``
    per head, ``-inf`` on the zero-norm padding edges;
  * ``alpha = segment_softmax(s)`` over each destination's incoming edges:
    the max through K5 (``kernels.seg_max``) on the detached logits, the
    denominator and the per-edge gathers' backward through K1;
  * the aggregate ``Σ alpha · z`` through K1 (``segment_sum_sorted``).

``encode`` is ``relu(attend(inb) + attend(outb) + x @ self_weight)`` then
dropout ``layer{i}``, for every layer.

Under a graph axis (``mesh.graph`` G > 1; ``rgat.py:221-312,500-535``) each
rank attends over its own edge slice (``attend_sharded``): K5 over the local
slice on the detached logits, a MAX over the graph group, K1 for the
denominator and a SUM whose backward sums the cotangents too (each rank
divides its own edges by it), K1 for the aggregate and a SUM that feeds the
replicated rest.  The replicated operands (``h`` and the attention
parameters) sum their per-shard gradients over the group once.  The per-head contractions are the
flat block-diagonal products of the JAX package's default layout
(``(E, d_out) @ (d_out, H)``); the alpha weighting broadcasts over the
``(E, H, dh)`` view of ``z``.  The JAX tests show both layouts compute one
function (``tests/test_rgat.py:234-261``).

Parameters keep the JAX names and shapes (``RGATLayerParams``), so
``convert.py`` maps a JAX ``RGATParams`` onto this module by name.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from kgc_gcn_torch.config import Config
from kgc_gcn_torch.data.graph import Graph, GraphHalf
from kgc_gcn_torch.models.common import dropout, xavier_uniform
from kgc_gcn_torch.models.decoders import build_decoder
from kgc_gcn_torch.models.family_base import DecoderFamilyMixin
from kgc_gcn_torch.ops import sorted_ops
from kgc_gcn_torch.ops.kernels import KERNELS, Kernels
from kgc_gcn_torch.ops.sorted_ops import (
    edge_compose, gather_rows_few, gather_rows_sorted, segment_sum_sorted)
from kgc_gcn_torch.parallel.distributed import (
    all_reduce_max, all_reduce_sum, copy_to_group, reduce_from_group)

NEG_SLOPE = 0.2


def block_matrix(att: torch.Tensor) -> torch.Tensor:
    """(H, dh) attention vectors -> the (H·dh, H) block-diagonal matrix
    whose column h holds head h's vector in its lane block
    (``rgat.py:_block_mats``)."""
    nh, dh = att.shape
    ind = torch.eye(nh, dtype=att.dtype, device=att.device).repeat_interleave(
        dh, dim=0)                                        # (H·dh, H) 0/1
    return att.reshape(-1, 1) * ind


def segment_softmax(logits: torch.Tensor, seg: torch.Tensor,
                    indptr: torch.Tensor, n_seg: int,
                    kernels: Kernels = KERNELS) -> torch.Tensor:
    """Per-segment softmax of (E, H) logits over non-decreasing ``seg``
    (``rgat.py:92-134``): ``-inf`` edges get weight 0 and empty segments
    stay finite.  The max is shift-invariant, so K5 sees detached logits."""
    smax = kernels.seg_max(logits.detach().contiguous(), seg, indptr, n_seg)
    smax_e = torch.where(torch.isfinite(smax), smax, 0.0)[seg.long()]
    expd = torch.where(torch.isfinite(logits), torch.exp(logits - smax_e), 0.0)
    denom = segment_sum_sorted(expd, seg, indptr, n_seg, kernels.seg_sum)
    denom_e = gather_rows_sorted(torch.clamp_min(denom, 1e-9), seg, indptr,
                                 n_seg, kernels.seg_sum)
    return expd / denom_e


class RGATLayer(nn.Module):
    """``RGATLayerParams`` (``rgat.py:66-74``, init ``:567-579``)."""

    def __init__(self, n_rel2: int, d_in: int, d_out: int, nh: int,
                 generator: torch.Generator):
        super().__init__()
        p = lambda *shape: nn.Parameter(xavier_uniform(shape, generator))
        dh = d_out // nh
        self.weight = p(d_in, d_out)
        self.rel_mult = nn.Parameter(
            1.0 + 0.1 * xavier_uniform((n_rel2, d_out), generator))
        self.att_src = p(nh, dh)
        self.att_dst = p(nh, dh)
        self.rel_bias = nn.Parameter(torch.zeros(n_rel2, nh))
        self.self_weight = p(d_in, d_out)

    def attend(self, h: torch.Tensor, half: GraphHalf, n_ent: int,
               kernels: Kernels,
               contrib_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """One direction's attention aggregation -> (N, d_out)
        (``rgat.py:_attend_half`` with ``use_pallas``); ``contrib_dtype`` is
        the type of ``edge_compose``'s d_h stream."""
        nh, dh = self.att_src.shape
        seg_sum = kernels.seg_sum
        z = edge_compose(h, self.rel_mult, half, seg_sum,
                         contrib_dtype)                         # (E, d_out)
        score_dst = h @ block_matrix(self.att_dst)              # (N, H)
        sd_e = gather_rows_sorted(score_dst, half.dst, half.indptr, n_ent,
                                  seg_sum)
        rb_e = gather_rows_few(self.rel_bias, half.rel,
                               half.r_indptr.shape[0] - 1,
                               (half.rperm, half.r_indptr, half.r_rel),
                               seg_sum)
        s = z @ block_matrix(self.att_src) + sd_e + rb_e        # (E, H)
        s = torch.nn.functional.leaky_relu(s, NEG_SLOPE)
        # padding edges (norm 0) take no part in the softmax
        s = torch.where(half.norm[:, None] > 0, s, float("-inf"))
        alpha = segment_softmax(s, half.dst, half.indptr, n_ent, kernels)
        msg = (z.view(-1, nh, dh) * alpha[:, :, None]).view(-1, nh * dh)
        return segment_sum_sorted(msg, half.dst, half.indptr, n_ent, seg_sum)


    def attend_sharded(self, h: torch.Tensor, halves, n_ent: int,
                       kernels: Kernels, group,
                       contrib_dtype: torch.dtype = torch.float32) -> list:
        """``attend`` of both halves over this rank's edge slices, combined
        over the graph group: [(N, d_out) per half]."""
        nh, dh = self.att_src.shape
        seg_sum = kernels.seg_sum
        h, rel_mult, att_src, att_dst, rel_bias = copy_to_group(
            group, h, self.rel_mult, self.att_src, self.att_dst,
            self.rel_bias)
        score_dst = h @ block_matrix(att_dst)                   # (N, H)
        zs, ss = [], []
        for half in halves:
            z = edge_compose(h, rel_mult, half, seg_sum, contrib_dtype)
            sd_e = gather_rows_sorted(score_dst, half.dst, half.indptr,
                                      n_ent, seg_sum)
            rb_e = gather_rows_few(rel_bias, half.rel,
                                   half.r_indptr.shape[0] - 1,
                                   (half.rperm, half.r_indptr, half.r_rel),
                                   seg_sum)
            s = torch.nn.functional.leaky_relu(
                z @ block_matrix(att_src) + sd_e + rb_e, NEG_SLOPE)
            zs.append(z)
            ss.append(torch.where(half.norm[:, None] > 0, s, float("-inf")))
        # a destination's edges may straddle shards: the max and the
        # denominator are combined over the group before any rank uses them
        smax = all_reduce_max(torch.cat([
            kernels.seg_max(s.detach().contiguous(), half.dst, half.indptr,
                            n_ent) for s, half in zip(ss, halves)]), group)
        expds = []
        for s, half, m in zip(ss, halves, smax.split(n_ent)):
            m_e = torch.where(torch.isfinite(m), m, 0.0)[half.dst.long()]
            expds.append(torch.where(torch.isfinite(s), torch.exp(s - m_e),
                                     0.0))
        denom = all_reduce_sum(torch.cat([
            segment_sum_sorted(e, half.dst, half.indptr, n_ent, seg_sum)
            for e, half in zip(expds, halves)]), group)
        outs = []
        for z, e, half, dn in zip(zs, expds, halves, denom.split(n_ent)):
            alpha = e / gather_rows_sorted(torch.clamp_min(dn, 1e-9),
                                           half.dst, half.indptr, n_ent,
                                           seg_sum)
            msg = (z.view(-1, nh, dh) * alpha[:, :, None]).view(-1, nh * dh)
            outs.append(segment_sum_sorted(msg, half.dst, half.indptr, n_ent,
                                           seg_sum))
        return list(reduce_from_group(torch.cat(outs), group).split(n_ent))


class RGAT(DecoderFamilyMixin, nn.Module):
    """Model family 'rgat' with any decoder (``cfg.decoder``)."""

    def __init__(self, cfg: Config, n_ent: int, n_rel: int, n_edge: int,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        self.mesh = mesh
        if cfg.num_heads < 1:
            raise ValueError(f"num_heads={cfg.num_heads} must be >= 1")
        self.nh = cfg.num_heads
        if cfg.gcn_out_dim % self.nh:
            raise ValueError(f"num_heads={self.nh} must divide "
                             f"gcn_out_dim={cfg.gcn_out_dim}")
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed % 2**32)
        self.cfg = cfg
        self.n_ent, self.n_rel, self.n_edge = n_ent, n_rel, n_edge
        n_rel2 = 2 * n_rel
        d = cfg.gcn_in_dim
        layers = []
        for _ in range(max(1, cfg.num_layers)):
            layers.append(RGATLayer(n_rel2, d, cfg.gcn_out_dim, self.nh,
                                    generator))
            d = cfg.gcn_out_dim
        self.layers = nn.ModuleList(layers)
        self.entity_embedding = nn.Parameter(
            xavier_uniform((n_ent, cfg.gcn_in_dim), generator))
        self.relation_embedding = nn.Parameter(
            xavier_uniform((n_rel2, cfg.gcn_out_dim), generator))
        self.decoder = build_decoder(cfg, n_ent, generator)

    def encode(self, graph: Graph, train: bool = False,
               rngs: Optional[Dict[str, torch.Generator]] = None,
               kernels: Kernels = KERNELS
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-graph encoder -> (all_ent (N, d_out), all_rel (2R, d_out))
        (``rgat.py:591-657``); ``kernels`` selects K5/K1 or their plain
        versions."""
        rngs = rngs or {}
        x = self.entity_embedding
        # KGC_EDGE_CONTRIB applies on the JAX package's use_pallas path
        # (spmm_pallas.py:1588-1596)
        stream = (torch.bfloat16 if self.cfg.use_pallas
                  and sorted_ops.EDGE_CONTRIB == "bf16" else torch.float32)
        group = self._graph_group(graph)
        for i, layer in enumerate(self.layers):
            h = x @ layer.weight
            if group is not None:
                agg_in, agg_out = layer.attend_sharded(
                    h, (graph.inb, graph.outb), self.n_ent, kernels, group,
                    stream)
            else:
                agg_in, agg_out = (
                    layer.attend(h, half, self.n_ent, kernels, stream)
                    for half in (graph.inb, graph.outb))
            agg = agg_in + agg_out + x @ layer.self_weight
            x = dropout(torch.relu(agg), self.cfg.gcn_drop,
                        rngs.get(f"layer{i}"), train)
        return x, self.relation_embedding
