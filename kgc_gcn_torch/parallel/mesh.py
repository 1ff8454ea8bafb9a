"""The process grid and what lives where on it (the counterpart of
``kgc_gcn_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``(data, graph)`` mesh and lets
GSPMD place the collectives.  The port runs one process per rank, laid out
as ``rank = d·G + g`` over ``data × graph``, with one process group per data
row (its G graph ranks, ``graph_group``) and one per graph column (its D data
ranks, ``data_group``):

  * ``data``: each step's batch plan ``(B,)`` is cut into D contiguous
    slices (``shard_batches``); gradients are summed over the data group;
  * ``graph``: each half's dst-sorted edge arrays are cut into G contiguous
    slices (``shard_graph``), with each slice's local CSR, and the per-edge
    table ``(2, E_pad, d)`` into ``(2, E_pad/G, d)`` along the edges,
    row-aligned with the slice (``shard_params``); Adam's moments for it
    follow.  Every other leaf is replicated.

A group of one rank is None: its collectives are no-ops.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from kgc_gcn_torch.data.graph import Graph
from kgc_gcn_torch.parallel.edge_parallel import local_half


@dataclass(frozen=True)
class Mesh:
    data: int                    # D: ranks that split the batch
    graph: int                   # G: ranks that split the edges
    rank: int
    device: torch.device
    data_group: Optional[object] = None    # this rank's graph column (D ranks)
    graph_group: Optional[object] = None   # this rank's data row (G ranks)

    @property
    def data_rank(self) -> int:
        return self.rank // self.graph

    @property
    def graph_rank(self) -> int:
        return self.rank % self.graph


def make_mesh(data: int, graph: int, device: torch.device) -> Mesh:
    """The grid over an initialised process group of ``data * graph`` ranks.
    Every rank makes every group, in the same order."""
    if data < 1 or graph < 1:
        raise ValueError(f"mesh {data}x{graph}: axes must be >= 1")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data * graph != world:
        raise ValueError(
            f"--data_axis {data} x --graph_axis {graph} needs a launcher "
            f"with WORLD_SIZE = {data * graph} ranks (torchrun); this "
            f"process group has WORLD_SIZE {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    graph_group = data_group = None
    for d in range(data):
        ranks = [d * graph + g for g in range(graph)]
        grp = dist.new_group(ranks) if graph > 1 else None
        if rank in ranks:
            graph_group = grp
    for g in range(graph):
        ranks = [d * graph + g for d in range(data)]
        grp = dist.new_group(ranks) if data > 1 else None
        if rank in ranks:
            data_group = grp
    logging.info("mesh: data=%d x graph=%d, rank %d = (data %d, graph %d)",
                 data, graph, rank, rank // graph, rank % graph)
    return Mesh(data, graph, rank, device, data_group, graph_group)


def check_mesh_shape(data: int, graph: int, batch_size: int,
                     eval_batch_size: int, e_pad: int) -> None:
    """The JAX CLI's checks of a mesh shape (``kgc_gcn_tpu/cli.py:336-352``),
    made before any work."""
    if batch_size % data:
        raise ValueError(f"data_axis={data} must divide "
                         f"batch_size={batch_size}")
    eval_bs = eval_batch_size or batch_size
    if eval_bs % data:
        raise ValueError(f"data_axis={data} must divide "
                         f"eval_batch_size={eval_bs}")
    if e_pad % graph:
        raise ValueError(
            f"graph_axis={graph} must divide the padded edge count {e_pad} "
            f"(powers of two up to {e_pad} always do)")


def shard_graph(graph: Graph, mesh: Mesh) -> Graph:
    """This rank's edge slice of both halves, with its local CSR
    (``edge_parallel.local_half``), on the mesh's device.  The stacked view
    is dropped: under a graph axis every schedule runs per half."""
    g = mesh.graph
    if graph.e_pad % g:
        raise ValueError(f"graph_axis={g} must divide the padded edge "
                         f"count {graph.e_pad}")
    return dataclasses.replace(
        graph, inb=local_half(graph.inb, g, mesh.graph_rank),
        outb=local_half(graph.outb, g, mesh.graph_rank), stacked=None,
        graph_shards=g).to(mesh.device)


def edge_slice(n: int, mesh: Mesh) -> slice:
    """This rank's rows of an ``n``-row edge axis."""
    e_loc = n // mesh.graph
    return slice(mesh.graph_rank * e_loc, (mesh.graph_rank + 1) * e_loc)


def edge_table_names(model) -> List[str]:
    """The model's per-edge tables: MGCN's ``(2, E_pad, d)`` positional
    tables, one per layer; the other families have none."""
    return [n for n, _ in model.named_parameters()
            if n == "edge_embeddings"
            or n.startswith("extra_edge_embeddings.")]


def shard_params(model, mesh: Mesh) -> None:
    """Put the model on the grid, in place and once: each per-edge table
    becomes this rank's ``(2, E_pad/G, d)`` slice (``edge_slice``), the
    decoder's batch BatchNorms take their moments over the data group, and
    the model learns its mesh (``model.prepare_edge_sharding``; under
    ``entity_sharded`` the model was built with it, and the Trainer calls
    ``prepare_entity_sharding`` instead, as the JAX Trainer does)."""
    if getattr(model, "sharded_on", None) is not None:
        return
    from kgc_gcn_torch.models.common import BatchNorm
    if mesh.graph > 1:
        for name in edge_table_names(model):
            *path, leaf = name.split(".")
            owner = model.get_submodule(".".join(path)) if path else model
            full = getattr(owner, leaf)
            setattr(owner, leaf, torch.nn.Parameter(
                full.detach()[:, edge_slice(full.shape[1], mesh)].clone()))
    for m in model.decoder.modules():
        if isinstance(m, BatchNorm):
            m.group = mesh.data_group
    if model.cfg.entity_sharded == "none":
        model.prepare_edge_sharding(mesh)
    model.sharded_on = mesh


def shard_like(full: torch.Tensor, local: torch.Tensor,
               mesh: Mesh) -> torch.Tensor:
    """``full`` cut like ``local``: this rank's edge slice of a per-edge
    table (or its moment) whose shape differs from the local leaf's, else
    ``full`` itself."""
    if tuple(full.shape) == tuple(local.shape):
        return full
    return full[:, edge_slice(full.shape[1], mesh)]


def shard_batches(mesh: Optional[Mesh], idx: np.ndarray, mask: np.ndarray):
    """This data rank's slice of each step of a ``(steps, B)`` plan."""
    if mesh is None or mesh.data == 1:
        return idx, mask
    b = idx.shape[1] // mesh.data
    cols = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    return idx[:, cols], mask[:, cols]
