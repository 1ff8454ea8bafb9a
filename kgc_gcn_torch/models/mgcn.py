"""M-GCN encoder + ConvE decoder, eval mode (the port's
``kgc_gcn_tpu/models/mgcn.py``).

  * Three xavier-initialized tables: entities ``(N, d_in)``, relations
    ``(2R, d_in)`` and one learned embedding per edge, stored positionally as
    ``(2, E_pad, d_in)``: ``[0]`` holds the in-half's edges in its dst-sorted
    order, ``[1]`` the out-half's (reference model.py:16-18).
  * One relational conv layer: per-edge messages ``x[src] * rel * edge``
    aggregated per direction half through the CSR segment-sum kernel, the
    direction weights applied after aggregation, a dense self-loop term,
    ``(in + out + loop) / 3``, BatchNorm, tanh; relations projected by
    ``rels_weight`` without the appended loop relation (model.py:82-118).
  * ``encode`` runs once per graph; ``decode`` scores queries against the
    encoded entity table.

Parameters keep the JAX layout and names (``in_weight`` is ``(d_in, d_out)``
used as ``x @ W``), so ``convert.py`` maps a JAX model onto this one by name.
Dropout never applies: this slice serves; training is the next one.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from kgc_gcn_torch.config import Config
from kgc_gcn_torch.data.graph import Graph, padded_edge_count
from kgc_gcn_torch.models.common import BatchNorm, mm, xavier_uniform
from kgc_gcn_torch.models.decoders import ConvE
from kgc_gcn_torch.ops.scatter import aggregate_half, loop_messages
from kgc_gcn_torch.ops.segment_sum import segment_sum


class MGCNConv(nn.Module):
    """Direction-typed relational conv weights (reference model.py:60-65)."""

    def __init__(self, d_in: int, d_out: int, generator: torch.Generator):
        super().__init__()
        p = lambda *shape: nn.Parameter(xavier_uniform(shape, generator))
        self.in_weight = p(d_in, d_out)
        self.out_weight = p(d_in, d_out)
        self.loop_weight = p(d_in, d_out)
        self.rels_weight = p(d_in, d_out)
        self.loop_rel = p(1, d_in)
        self.loop_edge = p(1, d_in)
        # no conv bias: the JAX package's MGCN.init never creates one, even
        # with cfg.bias (which adds ConvE's conv_b only)
        self.bn = BatchNorm(d_out)


class MGCN(nn.Module):
    """Model family 'mgcn' with the ConvE decoder."""

    def __init__(self, cfg: Config, n_ent: int, n_rel: int, n_edge: int,
                 e_pad: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed % 2**32)
        self.cfg = cfg
        self.n_ent, self.n_rel, self.n_edge = n_ent, n_rel, n_edge
        # must match the Graph's padded per-half edge count (build_graph)
        self.e_pad = e_pad if e_pad is not None else padded_edge_count(n_edge)
        d_in, d_out = cfg.gcn_in_dim, cfg.gcn_out_dim
        self.conv = MGCNConv(d_in, d_out, generator)
        self.decoder = ConvE(cfg, n_ent, generator)
        self.entity_embedding = nn.Parameter(
            xavier_uniform((n_ent, d_in), generator))
        self.relation_embedding = nn.Parameter(
            xavier_uniform((2 * n_rel, d_in), generator))
        # xavier bound from the REFERENCE shape (2E, d_in), so the real rows'
        # distribution matches reference utils.py:113-118; padding rows meet
        # zero-norm edges and never contribute
        b = math.sqrt(6.0 / (2 * n_edge + d_in))
        self.edge_embeddings = nn.Parameter(torch.empty(
            2, self.e_pad, d_in).uniform_(-b, b, generator=generator))

    def encode(self, graph: Graph, seg_sum=segment_sum
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-graph encoder, eval mode -> (all_ent (N, d_out),
        all_rel (2R, d_out)).  ``seg_sum`` selects the segment-sum; the
        default dispatches to the kernel on the card."""
        cfg = self.cfg
        c = self.conv
        dt = cfg.compute_dtype
        x = self.entity_embedding
        rel_all = torch.cat([self.relation_embedding, c.loop_rel], dim=0)
        in_agg = aggregate_half(x, rel_all, self.edge_embeddings[0], graph.inb,
                                self.n_ent, dt, seg_sum)
        out_agg = aggregate_half(x, rel_all, self.edge_embeddings[1],
                                 graph.outb, self.n_ent, dt, seg_sum)
        loop_res = mm(loop_messages(x, c.loop_rel, c.loop_edge),
                      c.loop_weight, dt)
        out = (mm(in_agg, c.in_weight, dt) + mm(out_agg, c.out_weight, dt)
               + loop_res) / 3.0
        all_ent = torch.tanh(c.bn(out))
        all_rel = mm(rel_all, c.rels_weight, dt)[:-1]
        return all_ent, all_rel

    def decode(self, all_ent: torch.Tensor, all_rel: torch.Tensor,
               src: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
        """(B,) query ids -> (B, N) logits over all entities."""
        return self.decoder(all_ent[src.long()], all_rel[rel.long()], all_ent)
