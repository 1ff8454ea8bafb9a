"""The entity-sharded schedules' plumbing (``cfg.entity_sharded``; the
counterpart of ``kgc_gcn_tpu/parallel/entity_sharding.py``).

The gather / ring / boundary schedules (``parallel/edge_parallel.py``,
``parallel/boundary.py``) split the entity rows over the graph group: rank
``g`` holds rows ``[g·n_pad/G, (g+1)·n_pad/G)`` of the ``n_pad =
ceil(N/G)·G`` padded rows, and no rank holds an (N, d) aggregate that
persists.  Every family whose per-half aggregation is gather -> compose ->
segment-sum rides them; what differs is the per-edge ``compose``:

  * MGCN: ``x[src] * rel_all[rel] * etab * norm`` (``compose=None``, which
    with ``use_pallas`` also selects the kernel forms: K1 per shard over
    ``n_pad`` rows for ``gather``, K1 per block for ``boundary``);
  * R-GCN basis: ``(x[src]·norm) ⊗ coeff[rel]``, (E, B·d_in), plain; the
    basis product runs after the exchange, on the rank's rows.

RGAT does not run ``agg_pair``: its softmax needs the max and the
denominator combined over the group before the weighted sum
(``models/rgat.py``); it takes the aggregator's ``rows`` and ``halves``.

Where JAX leaves the layout of the encoder's tail to GSPMD, the port spells
it out (``EntityRows``): the weight products, the loop term, the combine,
BatchNorm (moments over the real rows, summed over the group), the
nonlinearity, dropout and the depth layers run on the rank's rows; one
``gather_from_group`` of the final rows feeds the decoder, which is the
same on every rank of the group.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from kgc_gcn_torch.data.graph import Graph, GraphHalf
from kgc_gcn_torch.ops.segment_sum import segment_sum
from kgc_gcn_torch.parallel.boundary import (
    build_boundary_plan, make_boundary_aggregate)
from kgc_gcn_torch.parallel.distributed import (
    copy_to_group, gather_from_group, scatter_to_group)
from kgc_gcn_torch.parallel.edge_parallel import (
    build_ring_blocks, local_half, make_entity_sharded_aggregate,
    make_entity_sharded_aggregate_pallas, make_ring_aggregate, mult_compose)

SCHEDULES = ("gather", "ring", "boundary")


class EntityRows:
    """This rank's block of the padded entity rows, and the row-wise pieces
    of an encoder that runs on it."""

    def __init__(self, mesh, n_ent: int):
        g = mesh.graph
        if g < 2:
            raise ValueError("entity_sharded needs a graph axis > 1")
        self.group, self.device = mesh.graph_group, mesh.device
        self.n_ent = n_ent
        self.n_pad = -(-n_ent // g) * g
        self.rows_per = self.n_pad // g
        self.lo = mesh.graph_rank * self.rows_per
        self.n_real = max(0, min(self.rows_per, n_ent - self.lo))
        self.mask = (torch.arange(self.rows_per, device=self.device)
                     < self.n_real).float()

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's padded rows of a replicated (N, d) tensor; the
        backward all_gathers, so the leaf's gradient is whole on every
        rank."""
        x = torch.nn.functional.pad(x, (0, 0, 0, self.n_pad - self.n_ent))
        return scatter_to_group(x, self.group)

    def whole(self, x_local: torch.Tensor) -> torch.Tensor:
        """The (N, d) rows from every rank's block, the same on every rank;
        the backward keeps this rank's rows of the cotangent."""
        return gather_from_group(x_local, self.group)[:self.n_ent]

    def weights(self, *tensors: torch.Tensor) -> tuple:
        """Replicated weights applied to this rank's rows: each rank's
        gradient is a part, summed over the group in one collective."""
        return copy_to_group(self.group, *tensors)

    def dropout(self, x_local: torch.Tensor, rate: float,
                generator: Optional[torch.Generator],
                train: bool) -> torch.Tensor:
        """``models.common.dropout`` of the rank's rows: the keep mask is
        drawn for all N rows from the stream every rank shares (the one
        process's draw) and cut to this rank's rows."""
        if not train or rate == 0.0 or generator is None:
            return x_local
        keep = torch.rand((self.n_ent,) + tuple(x_local.shape[1:]),
                          generator=generator, device=x_local.device) >= rate
        keep = torch.nn.functional.pad(
            keep[self.lo:self.lo + self.n_real],
            (0, 0, 0, self.rows_per - self.n_real))
        return torch.where(keep, x_local / (1.0 - rate), 0.0)


class EntityShardedAggregator:
    """Builds and runs one entity-sharded schedule for a (cfg, mesh, N).

    ``compose=None`` selects MGCN's multiplicative form and, with
    ``cfg.use_pallas``, the kernel forms (gather + K1 per shard, boundary +
    K1 per block); a custom compose runs the plain block compute.  After
    ``prepare``: ``rows`` (``EntityRows``), ``halves`` (the rank's edge
    slice of each half, its CSR over the ``n_pad`` rows, which RGAT's
    attend also takes), ``boundary`` (each half's boundary aggregate) and
    ``boundary_stats``."""

    def __init__(self, cfg, mesh, n_ent: int,
                 compose: Optional[Callable] = None):
        if cfg.entity_sharded not in SCHEDULES:
            raise ValueError(f"entity_sharded={cfg.entity_sharded!r}: one of "
                             f"{SCHEDULES}")
        self.cfg, self.mesh = cfg, mesh
        self.rows = EntityRows(mesh, n_ent)
        self.kernel_path = cfg.use_pallas and compose is None
        self.compose = compose or mult_compose
        self.halves: Tuple[GraphHalf, ...] = ()
        self.boundary: Tuple[object, ...] = ()
        self.boundary_stats = None
        self._agg: Optional[Callable] = None

    @property
    def n_pad(self) -> int:
        return self.rows.n_pad

    def prepare(self, graph: Graph) -> None:
        """Host-side schedule construction from the WHOLE graph (every
        rank's plan is built from all slices).  Idempotent."""
        if self._agg is not None:
            return
        cfg, mesh, n_pad = self.cfg, self.mesh, self.n_pad
        g, rank, dev = mesh.graph, mesh.graph_rank, mesh.device
        group, schedule = mesh.graph_group, cfg.entity_sharded
        halves, rings, boundary, stats = [], [], [], {}
        for name in ("inb", "outb"):
            half = getattr(graph, name).to("cpu")
            halves.append(local_half(half, g, rank, n_pad).to(dev))
            if schedule == "ring":
                blocks, mask = build_ring_blocks(half, g, n_pad)
                rings.append((torch.from_numpy(blocks[rank]).to(dev),
                              torch.from_numpy(mask[rank]).to(dev)))
            elif schedule == "boundary":
                plan, stats[name] = build_boundary_plan(half, g, n_pad)
                boundary.append(make_boundary_aggregate(
                    group, plan, halves[-1], self.kernel_path,
                    cfg.compute_dtype,
                    None if self.kernel_path else self.compose))
        self.halves, self.boundary = tuple(halves), tuple(boundary)
        self.boundary_stats = stats or None
        if schedule == "boundary":
            def agg(x_local, rel_all, etabs, seg_sum):
                (rel_all,) = copy_to_group(group, rel_all)
                return [b(x_local, rel_all, et, seg_sum)
                        for b, et in zip(self.boundary, etabs)]
        elif schedule == "ring":
            ring = make_ring_aggregate(group, n_pad, self.compose)
            agg = lambda x_local, rel_all, etabs, seg_sum: ring(
                x_local, rel_all, etabs, self.halves, rings)
        else:
            gather = (make_entity_sharded_aggregate_pallas(
                group, n_pad, cfg.compute_dtype) if self.kernel_path
                else make_entity_sharded_aggregate(group, n_pad,
                                                   self.compose))
            agg = lambda x_local, rel_all, etabs, seg_sum: gather(
                x_local, rel_all, etabs, self.halves, seg_sum)
        self._agg = agg

    def agg_pair(self, x_local: torch.Tensor, rel_all: torch.Tensor,
                 et_pair, seg_sum: Callable = segment_sum
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both halves' aggregate of the rank's rows ``x_local`` (n_pad/G,
        d) -> ``(in, out)``, each (n_pad/G, d_msg) of this rank's rows.
        ``et_pair`` is the rank's slice of the (2, E_pad, d) per-edge table,
        or ``(None, None)``; ``seg_sum`` is K1 or its plain version."""
        if self._agg is None:
            raise RuntimeError("call prepare(graph) before agg_pair")
        return tuple(self._agg(x_local, rel_all, (et_pair[0], et_pair[1]),
                               seg_sum))
