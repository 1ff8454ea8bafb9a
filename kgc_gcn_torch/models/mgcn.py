"""M-GCN encoder + ConvE decoder (the port's ``kgc_gcn_tpu/models/mgcn.py``).

  * Three xavier-initialized tables: entities ``(N, d_in)``, relations
    ``(2R, d_in)`` and one learned embedding per edge, stored positionally as
    ``(2, E_pad, d_in)``: ``[0]`` holds the in-half's edges in its dst-sorted
    order, ``[1]`` the out-half's (reference model.py:16-18).
  * One relational conv layer: per-edge messages ``x[src] * rel * edge``
    aggregated per direction half through the CSR segment-sum kernel K1
    (``spmm_mode=halves``; with ``ew_impl=pallas`` the compose and the
    backward's products run through K4a/K4b), or both halves at once over
    the stacked view (``stacked_xla``: K1 over 2N rows; ``stacked``: K3),
    the direction weights applied after aggregation, a dense self-loop term,
    ``(in + out + loop) / 3``, BatchNorm, tanh; relations projected by
    ``rels_weight`` without the appended loop relation (model.py:82-118).
  * ``encode`` runs once per graph (per step in training); ``decode``,
    ``query_and_bias`` and ``score_candidates`` come from
    ``models/family_base.py``.
  * Training (``train=True``): BatchNorm on batch statistics, moving its
    running ones in place, and dropout at the sites of ``make_rngs``:
    ``conv_in``/``conv_out`` on the two direction results (not the loop
    term), ``gcn`` on the encoded entities before both the query gather and
    the scoring product, ``feat``/``hidden`` in the decoder.

Parameters keep the JAX layout and names (``in_weight`` is ``(d_in, d_out)``
used as ``x @ W``), so ``convert.py`` maps a JAX model onto this one by name.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from kgc_gcn_torch.config import Config
from kgc_gcn_torch.data.graph import Graph, padded_edge_count
from kgc_gcn_torch.models.common import BatchNorm, dropout, mm, xavier_uniform
from kgc_gcn_torch.models.decoders import ConvE
from kgc_gcn_torch.models.family_base import DecoderFamilyMixin
from kgc_gcn_torch.ops.fused_compose import aggregate_stacked
from kgc_gcn_torch.ops.kernels import KERNELS, Kernels
from kgc_gcn_torch.ops.scatter import (
    aggregate_half, aggregate_stacked_xla, loop_messages)


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


class MGCN(DecoderFamilyMixin, nn.Module):
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
        # the JAX package's two warnings (mgcn.py:143-157)
        if cfg.spmm_mode == "stacked_xla" and cfg.compute_dtype == "bfloat16":
            logging.warning(
                "spmm_mode=stacked_xla with compute_dtype=bfloat16: the JAX "
                "package measured this slower than spmm_mode=halves on its "
                "TPU at FB15k scale (BENCH_NOTES round 3); use "
                "spmm_mode=halves with bfloat16.")
        if cfg.spmm_mode != "halves" and (cfg.bwd_perm != "contrib"
                                          or cfg.ew_impl != "xla"):
            logging.warning(
                "spmm_mode=%s uses the contrib backward and the plain "
                "elementwise path; non-default bwd_perm/ew_impl are IGNORED "
                "(A/B those flags with spmm_mode=halves)", cfg.spmm_mode)

    def encode(self, graph: Graph, train: bool = False,
               rngs: Optional[Dict[str, torch.Generator]] = None,
               kernels: Kernels = KERNELS
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-graph encoder -> (all_ent (N, d_out), all_rel (2R, d_out)).
        The aggregation follows ``cfg.spmm_mode`` and ``cfg.ew_impl``
        (``mgcn.py:272-316,456-488``); ``kernels`` selects the kernels or
        their plain versions (default: the kernels on the card)."""
        cfg = self.cfg
        rngs = rngs or {}
        c = self.conv
        dt = cfg.compute_dtype
        x = self.entity_embedding
        rel_all = torch.cat([self.relation_embedding, c.loop_rel], dim=0)
        if cfg.spmm_mode in ("stacked", "stacked_xla"):
            # the whole positional table as (2*E_pad, d_in), a view:
            # stacked position k is its row k
            etab2 = self.edge_embeddings.reshape(2 * self.e_pad, -1)
            if cfg.spmm_mode == "stacked":
                # one K3 call for both halves, float32 messages whatever
                # compute_dtype is (mgcn.py:286-299)
                in_agg, out_agg = aggregate_stacked(
                    x, rel_all, etab2, graph.stacked, self.n_ent,
                    kernels.fused_compose, kernels.seg_sum)
            else:
                # one K1 launch over 2N rows, messages in compute_dtype
                # (mgcn.py:272-285)
                in_agg, out_agg = aggregate_stacked_xla(
                    x, rel_all, etab2, graph.stacked, self.n_ent, dt,
                    kernels.seg_sum)
        else:
            ew = ((kernels.compose_msg, kernels.bwd_products)
                  if cfg.ew_impl == "pallas" else None)
            in_agg, out_agg = (
                aggregate_half(x, rel_all, self.edge_embeddings[i], half,
                               self.n_ent, dt, kernels.seg_sum, ew=ew)
                for i, half in enumerate((graph.inb, graph.outb)))
        loop_res = mm(loop_messages(x, c.loop_rel, c.loop_edge),
                      c.loop_weight, dt)
        # (drop(in) + drop(out) + loop) / 3 — the loop term is NOT dropped
        # (reference model.py:103)
        out = (dropout(mm(in_agg, c.in_weight, dt), cfg.conv_drop,
                       rngs.get("conv_in"), train)
               + dropout(mm(out_agg, c.out_weight, dt), cfg.conv_drop,
                         rngs.get("conv_out"), train)
               + loop_res) / 3.0
        all_ent = torch.tanh(c.bn(out, train))
        all_rel = mm(rel_all, c.rels_weight, dt)[:-1]
        # post-encoder entity dropout (reference model.py:34), before BOTH
        # the query gather and the all-entity scoring product
        all_ent = dropout(all_ent, cfg.gcn_drop, rngs.get("gcn"), train)
        return all_ent, all_rel

    def make_rngs(self, generator: torch.Generator
                  ) -> Dict[str, torch.Generator]:
        """The dropout sites of one training step, each drawing from the
        trainer's one generator in the order the step reaches them
        (``mgcn.py:553-563``; a site missing here would silently not drop)."""
        return dict.fromkeys(("conv_in", "conv_out", "gcn", "feat", "hidden"),
                             generator)
