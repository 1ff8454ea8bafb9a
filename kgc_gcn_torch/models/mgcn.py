"""M-GCN encoder + a decoder (the port's ``kgc_gcn_tpu/models/mgcn.py``).

  * Three xavier-initialized tables: entities ``(N, d_in)``, relations
    ``(2R, d_in)`` and one learned embedding per edge, stored positionally as
    ``(2, E_pad, d_in)``: ``[0]`` holds the in-half's edges in its dst-sorted
    order, ``[1]`` the out-half's (reference model.py:16-18).
  * A relational conv layer: per-edge messages ``phi(x[src], rel) * edge``
    (``phi`` the composition: ``mult``, ``sub`` or ``corr``) aggregated per
    direction half through the CSR segment-sum kernel K1
    (``spmm_mode=halves``; with ``ew_impl=pallas`` the compose and the
    backward's products run through K4a/K4b), or both halves at once over
    the stacked view (``stacked_xla``: K1 over 2N rows; ``stacked``: K3),
    the direction weights applied after aggregation, a dense self-loop term,
    ``(in + out + loop) / 3``, BatchNorm, tanh; relations projected by
    ``rels_weight`` without the appended loop relation (model.py:82-118).
    ``sub`` and ``corr`` compose on ``halves`` and ``stacked_xla``; K3 and
    K4a/K4b compose by multiplication and refuse them.
  * Depth (``num_layers > 1``, ``mgcn.py:209-233,334-364``): each further
    layer has its own ``MGCNConv`` (d_out -> d_out, BatchNorm included) in
    ``extra_convs`` and its own ``(2, E_pad, d_out)`` per-edge table in
    ``extra_edge_embeddings``, takes the previous layer's entity and
    relation outputs, and always runs the ``halves`` schedule.
  * Edge sampling (``edge_sample_size`` K > 0, one layer, training only):
    each half aggregates K edges drawn on the device (``ops/sampler.py``),
    summed with ``index_add_``; evaluation encodes the full graph.  Under
    a graph axis each rank sums the drawn edges of its slice, then one SUM
    (``parallel/edge_parallel.py:make_sampled_aggregate``).
  * ``agg_schedule=reference`` (bench only): every edge message projected
    and summed unsorted (``ops/scatter.py:
    aggregate_half_reference_schedule``); under a graph axis per edge
    slice, then one SUM (``make_reference_aggregate``).
  * Under a graph axis (``mesh.graph`` G > 1, ``mgcn.py:405-470``): every
    layer's halves run per shard, each rank's slice of the edges through K1
    over its local CSR into the full (N, d) rows, then one SUM over the
    graph group (``parallel/edge_parallel.py:
    make_pallas_sharded_aggregate``); the per-edge tables hold the rank's
    ``(2, E_pad/G, d)`` slice (``parallel/mesh.py:shard_params``).
    ``spmm_mode`` then runs ``halves`` (with ``use_pallas``, another mode is
    refused, as in the JAX package), and ``ew_impl``, ``bwd_perm`` and
    ``rel_compose`` take their defaults, with a warning.
  * Entity-sharded (``entity_sharded`` gather | ring | boundary, a graph
    axis G > 1; ``mgcn.py:121-142,300-303,343-349,387-401``): the entity
    rows are split over the graph group (``parallel/entity_sharding.py``);
    every layer's halves run the schedule on the rank's rows (with
    ``use_pallas``: K1 per shard for ``gather``, K1 per block for
    ``boundary``), and so do the weight products, the loop term, the
    combine, BatchNorm (moments over the real rows of the group), tanh and
    the dropout sites (their masks drawn for all N rows); one
    ``gather_from_group`` of the last layer's rows feeds the decoder.
  * ``encode`` runs once per graph (per step in training); ``decode``,
    ``query_and_bias`` and ``score_candidates`` come from
    ``models/family_base.py``.
  * Training (``train=True``): BatchNorm on batch statistics, moving its
    running ones in place, and dropout at the sites of ``make_rngs``:
    ``conv_in``/``conv_out`` (``conv_in{i}``/``conv_out{i}`` in depth layer
    i) on the two direction results (not the loop term), ``layer{i}``
    (``gcn_drop``) on the entities entering depth layer i, ``gcn`` on the
    encoded entities before both the query gather and the scoring product,
    ``feat``/``hidden`` in the decoder.

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
from kgc_gcn_torch.models.decoders import build_decoder
from kgc_gcn_torch.models.family_base import (
    DecoderFamilyMixin, check_entity_sharded_mesh)
from kgc_gcn_torch.ops import sampler, scatter
from kgc_gcn_torch.ops.fused_compose import aggregate_stacked
from kgc_gcn_torch.ops.kernels import KERNELS, Kernels
from kgc_gcn_torch.ops.scatter import (
    aggregate_half, aggregate_stacked_xla, loop_messages)
from kgc_gcn_torch.parallel.edge_parallel import (
    make_pallas_sharded_aggregate, make_reference_aggregate,
    make_sampled_aggregate)


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
        self.bn = BatchNorm(d_out)
        # the optional (d_out,) conv bias (mgcn.py:54): init never makes it,
        # even with cfg.bias (which adds ConvE's conv_b only); only an
        # imported reference checkpoint brings it (``set_bias``)
        self.register_parameter("bias", None)

    def set_bias(self, bias: Optional[torch.Tensor]) -> None:
        """Give the layer a conv bias with these values, or none."""
        self.bias = None if bias is None else nn.Parameter(
            bias.detach().to(self.bn.scale.device, torch.float32).clone())


def _edge_table(n_edge: int, e_pad: int, d: int,
                generator: torch.Generator) -> nn.Parameter:
    """A positional (2, E_pad, d) per-edge table.  The xavier bound comes
    from the REFERENCE shape (2E, d), so the real rows' distribution matches
    reference utils.py:113-118; padding rows meet zero-norm edges and never
    contribute."""
    b = math.sqrt(6.0 / (2 * n_edge + d))
    return nn.Parameter(torch.empty(2, e_pad, d).uniform_(
        -b, b, generator=generator))


def check_config(cfg: Config, graph_axis: int = 1) -> None:
    """The JAX package's refusals (``mgcn.py:110-142,158-165``) and the
    port's schedules that compose by multiplication only (K3, K4a/K4b)."""
    if cfg.num_layers > 1 and cfg.edge_sample_size > 0:
        raise ValueError(
            "edge_sample_size is only supported with num_layers=1")
    if cfg.composition != "mult" and (
            cfg.use_pallas or cfg.edge_sample_size > 0
            or cfg.agg_schedule == "reference"):
        raise ValueError(
            f"composition={cfg.composition!r} requires the default XLA "
            "aggregation path (use_pallas=False, edge_sample_size=0, "
            "agg_schedule='fused'); the Pallas kernels and the reference "
            "bench schedule compose multiplicatively")
    if cfg.entity_sharded != "none":
        unsupported = [
            # gather: per-shard CSR; boundary: per-block CSR; the ring runs
            # the plain compose
            ("use_pallas", cfg.use_pallas
             and cfg.entity_sharded not in ("gather", "boundary")),
            ("edge_sample_size", cfg.edge_sample_size > 0),
            ("composition", cfg.composition != "mult"),
            ("agg_schedule", cfg.agg_schedule != "fused"),
        ]
        bad = [k for k, v in unsupported if v]
        if bad:
            raise ValueError(
                f"entity_sharded={cfg.entity_sharded!r} supports the mult "
                "composition only (and use_pallas only with the gather and "
                f"boundary schedules); incompatible flags: {bad}")
    if cfg.composition != "mult" and (cfg.spmm_mode == "stacked"
                                      or cfg.ew_impl == "pallas"):
        raise ValueError(
            f"composition={cfg.composition!r} cannot run on K3 "
            "(spmm_mode='stacked') or K4a/K4b (ew_impl='pallas'): they "
            "compose by multiplication")
    if graph_axis > 1 and cfg.use_pallas and cfg.spmm_mode != "halves":
        raise ValueError(
            f"spmm_mode={cfg.spmm_mode!r} cannot ride an edge partition: "
            "its one call covers both halves' whole edge lists; use "
            "spmm_mode='halves' (per-shard K1) with graph_axis > 1")


def _on_rows(rows, *weights: torch.Tensor) -> tuple:
    """Weights applied to the rank's entity rows (their gradients summed
    over the graph group), or the weights themselves without ``rows``."""
    return weights if rows is None else rows.weights(*weights)


def _contrib_dtype(cfg: Config, bwd_perm: str, k4b: bool) -> str:
    """The type of the backward's d_x stream (``ops/scatter.py``): bf16
    where the JAX package casts it under ``MGCN_CONTRIB=bf16``
    (``spmm_pallas.py:664-668``: the ``use_pallas`` path, float32 messages,
    the ``contrib`` schedule's plain products, not K4b), else the message
    type."""
    bf16 = (cfg.use_pallas and scatter.MGCN_CONTRIB == "bf16"
            and cfg.compute_dtype == "float32" and bwd_perm == "contrib"
            and not k4b)
    return "bfloat16" if bf16 else cfg.compute_dtype


class MGCN(DecoderFamilyMixin, nn.Module):
    """Model family 'mgcn' with any decoder (``cfg.decoder``)."""

    def __init__(self, cfg: Config, n_ent: int, n_rel: int, n_edge: int,
                 e_pad: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        check_config(cfg, mesh.graph if mesh is not None else 1)
        check_entity_sharded_mesh(cfg, mesh)
        self.mesh = mesh
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed % 2**32)
        self.cfg = cfg
        self.n_ent, self.n_rel, self.n_edge = n_ent, n_rel, n_edge
        # must match the Graph's padded per-half edge count (build_graph)
        self.e_pad = e_pad if e_pad is not None else padded_edge_count(n_edge)
        d_in, d_out = cfg.gcn_in_dim, cfg.gcn_out_dim
        self.conv = MGCNConv(d_in, d_out, generator)
        self.decoder = build_decoder(cfg, n_ent, generator)
        self.entity_embedding = nn.Parameter(
            xavier_uniform((n_ent, d_in), generator))
        self.relation_embedding = nn.Parameter(
            xavier_uniform((2 * n_rel, d_in), generator))
        self.edge_embeddings = _edge_table(n_edge, self.e_pad, d_in, generator)
        n_extra = max(1, cfg.num_layers) - 1
        self.extra_convs = nn.ModuleList(
            MGCNConv(d_out, d_out, generator) for _ in range(n_extra))
        self.extra_edge_embeddings = nn.ParameterList(
            _edge_table(n_edge, self.e_pad, d_out, generator)
            for _ in range(n_extra))
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
        Layer 1's aggregation follows the sampler in training, then
        ``cfg.spmm_mode``, ``cfg.agg_schedule`` and ``cfg.ew_impl``
        (``mgcn.py:242-344,456-488``); ``kernels`` selects the kernels or
        their plain versions (default: the kernels on the card)."""
        cfg = self.cfg
        rngs = rngs or {}
        c = self.conv
        dt = cfg.compute_dtype
        # entity-sharded: this rank's block of the padded entity rows
        rows = self.entity_rows
        x = (self.entity_embedding if rows is None
             else rows.take(self.entity_embedding))
        rel_all = torch.cat([self.relation_embedding, c.loop_rel], dim=0)
        group = self._graph_group(graph)
        if train and cfg.edge_sample_size > 0 and "sample_in" in rngs:
            # K edges per half drawn on the device, rescaled by E/K
            # (mgcn.py:259-271): an unsorted sum, projected in float32.
            # Under a graph axis every rank draws the same positions and
            # sums those of its edge slice, then one SUM over the group
            lo = 0 if group is None else (self.mesh.graph_rank
                                          * graph.inb.src.shape[0])
            samples = [sampler.take_slice(
                half, sampler.draw_positions(
                    rngs[name], cfg.edge_sample_size, self.n_edge,
                    half.src.device), lo, self.n_edge)
                for half, name in ((graph.inb, "sample_in"),
                                   (graph.outb, "sample_out"))]
            in_agg, out_agg = make_sampled_aggregate(group, self.n_ent)(
                x, rel_all, self.edge_embeddings, samples)
            in_res, out_res = in_agg @ c.in_weight, out_agg @ c.out_weight
        elif cfg.spmm_mode in ("stacked", "stacked_xla") and group is None:
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
                    kernels.seg_sum, composition=cfg.composition,
                    contrib_dtype=_contrib_dtype(cfg, "contrib", k4b=False))
            in_res, out_res = (mm(in_agg, c.in_weight, dt),
                               mm(out_agg, c.out_weight, dt))
        elif cfg.agg_schedule == "reference":
            # project every edge message, then an unsorted sum (bench
            # only); under a graph axis per edge slice, then one SUM
            in_res, out_res = make_reference_aggregate(group, self.n_ent)(
                x, rel_all, self.edge_embeddings, (graph.inb, graph.outb),
                (c.in_weight, c.out_weight))
        else:
            in_agg, out_agg = self._agg_halves(x, rel_all,
                                               self.edge_embeddings, graph,
                                               kernels)
            w_in, w_out = _on_rows(rows, c.in_weight, c.out_weight)
            in_res, out_res = mm(in_agg, w_in, dt), mm(out_agg, w_out, dt)
        all_ent, all_rel = self._combine(c, x, rel_all, in_res, out_res,
                                         train, rngs, "", rows)
        # depth layers: layer i + 2 takes layer i + 1's entity and relation
        # outputs, with its own per-edge table (mgcn.py:334-364); under
        # entity sharding they chain through the same schedules
        drop = dropout if rows is None else rows.dropout
        for i, (ck, et_k) in enumerate(zip(self.extra_convs,
                                           self.extra_edge_embeddings)):
            x_k = drop(all_ent, cfg.gcn_drop, rngs.get(f"layer{i}"), train)
            rel_k = torch.cat([all_rel, ck.loop_rel], dim=0)
            in_agg, out_agg = self._agg_halves(x_k, rel_k, et_k, graph,
                                               kernels)
            w_in, w_out = _on_rows(rows, ck.in_weight, ck.out_weight)
            all_ent, all_rel = self._combine(
                ck, x_k, rel_k, mm(in_agg, w_in, dt), mm(out_agg, w_out, dt),
                train, rngs, str(i), rows)
        if rows is not None:   # every rank's rows, for the decoder
            all_ent = rows.whole(all_ent)
        # post-encoder entity dropout (reference model.py:34), before BOTH
        # the query gather and the all-entity scoring product
        all_ent = dropout(all_ent, cfg.gcn_drop, rngs.get("gcn"), train)
        return all_ent, all_rel

    def _agg_halves(self, x: torch.Tensor, rel_all: torch.Tensor,
                    et_full: torch.Tensor, graph: Graph, kernels: Kernels
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both direction halves of a (2, E_pad, d) edge table through K1
        (``mgcn.py:_agg_halves``), with K4a/K4b under ``ew_impl=pallas``.
        With ``use_pallas`` the JAX package's ``bwd_perm`` ``operands`` and
        ``fwdw`` compose the backward's products in XLA, not K4b
        (``spmm_pallas.py:651-662``); the port takes its plain products
        there, and the ``contrib`` schedule's gradients for all three."""
        cfg = self.cfg
        group = self._graph_group(graph)
        if self.entity_sharding is not None:
            # the rank's rows through the entity-sharded schedule
            return self.entity_sharding.agg_pair(x, rel_all, et_full,
                                                 kernels.seg_sum)
        if group is not None:
            # per shard over the local CSR, then one SUM (mgcn.py:455-470)
            agg = make_pallas_sharded_aggregate(
                group, self.n_ent, cfg.compute_dtype, kernels.seg_sum,
                cfg.composition)
            return tuple(agg(x, rel_all, (et_full[0], et_full[1]),
                             (graph.inb, graph.outb)))
        perm = cfg.bwd_perm if cfg.use_pallas else "contrib"
        k4b = cfg.ew_impl == "pallas" and perm == "contrib"
        ew = ((kernels.compose_msg, kernels.bwd_products if k4b else None)
              if cfg.ew_impl == "pallas" else None)
        return tuple(
            aggregate_half(x, rel_all, et_full[i], half, self.n_ent,
                           cfg.compute_dtype, kernels.seg_sum, ew=ew,
                           composition=cfg.composition,
                           contrib_dtype=_contrib_dtype(cfg, perm, k4b))
            for i, half in enumerate((graph.inb, graph.outb)))

    def prepare_edge_sharding(self, mesh) -> None:
        """The JAX package's warning (``mgcn.py:416-427``): under a graph
        axis the per-shard schedule runs the default ``contrib``, ``gather``
        and plain elementwise paths.  Called by ``parallel.mesh.
        shard_params``, which slices the per-edge tables."""
        super().prepare_edge_sharding(mesh)
        cfg = self.cfg
        ignored = [k for k, v, dflt in (
            ("bwd_perm", cfg.bwd_perm, "contrib"),
            ("rel_compose", cfg.rel_compose, "gather"),
            ("ew_impl", cfg.ew_impl, "xla")) if v != dflt]
        if mesh.graph > 1 and ignored:
            logging.warning(
                "the per-shard edge-partition schedule uses the default "
                "contrib/gather/xla paths; non-default %s are IGNORED under "
                "graph_axis > 1 (A/B those flags on one device)", ignored)

    def _combine(self, c: MGCNConv, x: torch.Tensor, rel_all: torch.Tensor,
                 in_res: torch.Tensor, out_res: torch.Tensor, train: bool,
                 rngs: Dict[str, torch.Generator], site: str, rows=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(drop(in) + drop(out) + loop) / 3`` (the loop term is NOT
        dropped, reference model.py:103), BatchNorm, tanh; relations
        projected without the appended loop relation.  With ``rows``
        (``EntityRows``) ``x`` and the results are the rank's entity
        rows."""
        cfg, dt = self.cfg, self.cfg.compute_dtype
        drop = dropout if rows is None else rows.dropout
        loop_rel, loop_edge, loop_w, *bias = _on_rows(
            rows, c.loop_rel, c.loop_edge, c.loop_weight,
            *([] if c.bias is None else [c.bias]))
        loop_res = mm(loop_messages(x, loop_rel, loop_edge, cfg.composition),
                      loop_w, dt)
        out = (drop(in_res, cfg.conv_drop, rngs.get(f"conv_in{site}"), train)
               + drop(out_res, cfg.conv_drop, rngs.get(f"conv_out{site}"),
                      train)
               + loop_res) / 3.0
        if bias:
            out = out + bias[0]
        return (torch.tanh(c.bn(out, train, rows)),
                mm(rel_all, c.rels_weight, dt)[:-1])

    def make_rngs(self, generator: torch.Generator
                  ) -> Dict[str, torch.Generator]:
        """The dropout and sampling sites of one training step, each drawing
        from the trainer's one generator, in the order the step reaches them
        (``mgcn.py:553-563``; a site missing here would silently not drop)."""
        names = ["sample_in", "sample_out", "conv_in", "conv_out"]
        for i in range(len(self.extra_convs)):
            names += [f"layer{i}", f"conv_in{i}", f"conv_out{i}"]
        return dict.fromkeys(names + ["gcn", *self.DECODER_SITES], generator)
