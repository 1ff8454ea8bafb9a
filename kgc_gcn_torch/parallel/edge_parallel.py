"""Edge-partitioned and entity-sharded aggregation (the counterpart of
``kgc_gcn_tpu/parallel/edge_parallel.py``).

Each rank of a data row holds a contiguous slice of each half's dst-sorted
edge list (``parallel/mesh.py:shard_graph``).  A slice of a dst-sorted list
is dst-sorted and covers a range of destination rows, so its CSR pointers are
the global ones clipped to the slice; the backward's src-sorted and
rel-sorted views are built per slice (``build_local_csr``).  A rank's slice
is a ``GraphHalf`` of its own (``local_half``), so every per-half operation of
the single-device path runs on it unchanged, into the full ``(N, d)`` rows,
or into ``n_pad`` rows (``n_rows_out``) for the entity-sharded schedules.

The edge-partitioned aggregate over the graph group is:

  * the replicated inputs (entity rows, relation table) through
    ``copy_to_group``, so that each rank's partial gradient is summed once;
  * the per-shard aggregate of each half: K1 over the local dst order
    forward, K1 over the local src order for d_x, the port's
    ``segment_sum_few`` for d_rel, d_etab dense and local to the shard
    (``make_pallas_sharded_aggregate``, through ``ops/scatter.py:
    aggregate_half``), or the plain compose and ``index_add_``
    (``make_sharded_aggregate``, what the JAX package's GSPMD path
    computes);
  * one SUM of both halves over the graph group (``reduce_from_group``: its
    result feeds replicated work, so the backward passes the cotangent
    through).

The entity-sharded schedules (``edge_parallel.py:249-484`` there) take the
entity rows split over the graph group instead: rank ``i`` holds rows
``[i·n_pad/G, (i+1)·n_pad/G)`` of the padded ``n_pad = ceil(N/G)·G`` rows,
and each aggregate returns the rank's rows of both halves:

  * ``gather``: one ``all_gather_rows`` of x for both halves, the per-shard
    aggregate into ``n_pad`` rows (the plain compose and ``index_add_``,
    ``make_entity_sharded_aggregate``; or K1 over the local CSR extended to
    ``n_pad`` rows, ``make_entity_sharded_aggregate_pallas``), and one
    ``reduce_scatter_rows`` of both halves side by side;
  * ``ring`` (``make_ring_aggregate``): the shard passed one rank on per step
    (``ppermute``), each step's edges those whose source lies in the shard
    held (``build_ring_blocks``), then the same ``reduce_scatter_rows``.  A
    Python loop of G steps takes the place of ``lax.scan``; the shard is not
    passed on after the last step.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from kgc_gcn_torch.data.graph import GraphHalf
from kgc_gcn_torch.ops.scatter import aggregate_half
from kgc_gcn_torch.ops.segment_sum import segment_sum
from kgc_gcn_torch.parallel.distributed import (
    all_gather_rows, copy_to_group, group_rank, group_size, ppermute,
    reduce_from_group, reduce_scatter_rows)


def mult_compose(x_rows, rel_all, rel_ids, et_rows, norm):
    """The MGCN message ``(x[src] * rel_all[rel] * etab) * norm``
    (reference model.py:111-118): the default compose of
    ``make_sharded_aggregate``, whose composes take ``(x_rows (E, d_in),
    rel_all (replicated table), rel_ids (E,), et_rows (E, d) or None,
    norm (E,)) -> (E, d_msg)``."""
    return (x_rows * rel_all[rel_ids] * et_rows) * norm[:, None]


def _shard_csr(half: GraphHalf, g_size: int, i: int,
               n_rows_out: Optional[int] = None):
    """Shard ``i``'s local CSR: (indptr, sperm, s_src, s_indptr, rperm,
    r_rel, r_indptr), int32 numpy arrays; with ``n_rows_out`` the row
    pointers span that many rows (the rows past N are empty)."""
    src, rel = half.src.cpu().numpy(), half.rel.cpu().numpy()
    e_pad = src.shape[0]
    if e_pad % g_size:
        raise ValueError(f"{g_size} shards do not divide {e_pad} edges")
    e_loc = e_pad // g_size
    lo = i * e_loc
    g_indptr = half.indptr.cpu().numpy().astype(np.int64)
    n_rows = g_indptr.shape[0] - 1
    if n_rows_out is not None:
        if n_rows_out < n_rows:
            raise ValueError(f"n_rows_out {n_rows_out} < {n_rows} rows")
        g_indptr = np.concatenate(
            [g_indptr, np.full(n_rows_out - n_rows, g_indptr[-1])])
        n_rows = n_rows_out
    n_rel_rows = half.r_indptr.shape[0] - 1
    i32 = lambda a: np.asarray(a, np.int32)
    ptr = lambda ids, n: i32(np.concatenate(
        [[0], np.cumsum(np.bincount(ids, minlength=n))]))
    indptr = np.clip(g_indptr - lo, 0, e_loc)
    ls, lr = src[lo: lo + e_loc], rel[lo: lo + e_loc]
    order = np.argsort(ls, kind="stable")
    rorder = np.argsort(lr, kind="stable")
    return (i32(indptr), i32(order), i32(ls[order]), ptr(ls, n_rows),
            i32(rorder), i32(lr[rorder]), ptr(lr, n_rel_rows))


def build_local_csr(half: GraphHalf, g_size: int,
                    n_rows_out: Optional[int] = None):
    """Per-shard CSR of the ``g_size`` contiguous slices of a dst-sorted
    half, as numpy arrays with a leading (G,) axis, the layout of the JAX
    package's ``build_local_csr``: ``indptr (G, N+1)`` (the global pointers
    clipped to the slice), ``sperm, s_src (G, E_loc)`` and ``s_indptr
    (G, N+1)`` (the slice sorted by src), ``rperm, r_rel (G, E_loc)`` and
    ``r_indptr (G, 2R+2)`` (the slice sorted by relation).  With
    ``n_rows_out`` (the entity-sharded schedules' ``n_pad``) the row
    pointers span ``n_rows_out + 1`` entries."""
    shards = [_shard_csr(half, g_size, i, n_rows_out) for i in range(g_size)]
    return tuple(np.stack(a) for a in zip(*shards))


def local_half(half: GraphHalf, g_size: int, rank: int,
               n_rows_out: Optional[int] = None) -> GraphHalf:
    """Shard ``rank``'s slice of a dst-sorted half as a ``GraphHalf`` of
    ``E_pad / g_size`` edges over the same N rows (or ``n_rows_out`` rows),
    with its local CSR, on the CPU."""
    half = half.to("cpu")
    e_loc = half.src.shape[0] // g_size
    lo, hi = rank * e_loc, (rank + 1) * e_loc
    indptr, sperm, s_src, s_indptr, rperm, r_rel, r_indptr = (
        torch.from_numpy(a) for a in _shard_csr(half, g_size, rank,
                                                 n_rows_out))
    cut = {f: getattr(half, f)[lo:hi].clone()
           for f in ("src", "dst", "rel", "eid", "norm")}
    sp = sperm.long()
    return GraphHalf(
        **cut, indptr=indptr, sperm=sperm, s_indptr=s_indptr, s_src=s_src,
        s_dst=cut["dst"][sp], s_norm=cut["norm"][sp], s_rel=cut["rel"][sp],
        rperm=rperm, r_indptr=r_indptr, r_rel=r_rel,
        e_real=int(min(max(half.e_real - lo, 0), e_loc)))


def make_pallas_sharded_aggregate(group, n_ent: int,
                                  msg_dtype: str = "float32",
                                  seg_sum: Callable = segment_sum,
                                  composition: str = "mult"):
    """The per-shard kernel aggregate (``make_pallas_sharded_aggregate`` and
    ``make_local_agg`` of the JAX package): returns ``agg(x, rel_all,
    etabs, halves) -> [(N, d) per half]``, where ``etabs`` are the halves'
    local table slices and ``halves`` their local ``GraphHalf`` s.  Each
    half runs ``ops/scatter.py:aggregate_half`` (K1 forward and for d_x,
    ``segment_sum_few`` for d_rel, d_etab local); both halves' sums cross
    the graph group in one SUM."""

    def agg(x: torch.Tensor, rel_all: torch.Tensor,
            etabs: Sequence[torch.Tensor],
            halves: Sequence[GraphHalf]) -> List[torch.Tensor]:
        x, rel_all = copy_to_group(group, x, rel_all)
        parts = [aggregate_half(x, rel_all, et, half, n_ent, msg_dtype,
                                seg_sum, composition=composition)
                 for et, half in zip(etabs, halves)]
        return list(reduce_from_group(torch.cat(parts), group)
                    .split(n_ent))

    return agg


def make_sharded_aggregate(group, n_rows: int,
                           compose: Callable = mult_compose):
    """The plain per-shard aggregate (``make_sharded_aggregate``, what the
    JAX package's GSPMD path computes): per half, ``compose`` the local
    edges' messages and ``index_add_`` them into ``(n_rows, d_msg)``, with
    autograd's backward; then one SUM of both halves over the graph group.
    Returns ``agg(x, rel_all, etabs, halves) -> [(n_rows, d_msg) per
    half]``; ``etabs`` entries may be None for a compose without a per-edge
    table."""

    def agg(x: torch.Tensor, rel_all: torch.Tensor, etabs,
            halves: Sequence[GraphHalf]) -> List[torch.Tensor]:
        x, rel_all = copy_to_group(group, x, rel_all)
        parts = []
        for et, half in zip(etabs, halves):
            msg = compose(x[half.src.long()], rel_all, half.rel.long(), et,
                          half.norm)
            parts.append(torch.zeros(n_rows, msg.shape[1], dtype=msg.dtype,
                                     device=msg.device)
                         .index_add(0, half.dst.long(), msg))
        return list(reduce_from_group(torch.cat(parts), group)
                    .split(n_rows))

    return agg



# ------------------------------------------------------ entity-sharded schedules

def _gather_schedule(group, local: Callable) -> Callable:
    """``agg(x_local, rel_all, etabs, halves, seg_sum)``: the group's entity
    rows gathered once for both halves, ``local(x, rel_all, etab, half,
    seg_sum)`` per half into ``n_pad`` rows, both halves reduce-scattered
    side by side in one collective -> [(n_pad / G, d_msg) per half]."""

    def agg(x_local: torch.Tensor, rel_all: torch.Tensor, etabs,
            halves: Sequence[GraphHalf],
            seg_sum: Callable = segment_sum) -> List[torch.Tensor]:
        x = all_gather_rows(x_local, group)
        (rel_all,) = copy_to_group(group, rel_all)
        parts = [local(x, rel_all, et, half, seg_sum)
                 for et, half in zip(etabs, halves)]
        out = reduce_scatter_rows(torch.cat(parts, dim=1), group)
        return list(out.split(parts[0].shape[1], dim=1))

    return agg


def make_entity_sharded_aggregate(group, n_pad: int,
                                  compose: Callable = mult_compose):
    """The plain gather schedule (``make_entity_sharded_aggregate``):
    ``compose`` the local edges' messages from the gathered rows and
    ``index_add_`` them into ``n_pad`` rows (``seg_sum`` is not used).
    ``halves`` are the rank's local halves; ``etabs`` entries may be
    None."""

    def local(x, rel_all, et, half, seg_sum):
        msg = compose(x[half.src.long()], rel_all, half.rel.long(), et,
                      half.norm)
        return torch.zeros(n_pad, msg.shape[1], dtype=msg.dtype,
                           device=msg.device).index_add(0, half.dst.long(),
                                                        msg)

    return _gather_schedule(group, local)


def make_entity_sharded_aggregate_pallas(group, n_pad: int,
                                         msg_dtype: str = "float32"):
    """The gather schedule on K1 (``make_entity_sharded_aggregate_pallas``):
    ``ops/scatter.py:aggregate_half`` per shard over ``n_pad`` rows (K1 in
    dst order forward, in src order for d_x, ``segment_sum_few`` for d_rel),
    summing with the call's ``seg_sum`` (K1 or its plain version).
    ``halves`` are the rank's local halves with the CSR over ``n_pad`` rows
    (``local_half(..., n_rows_out=n_pad)``)."""

    def local(x, rel_all, et, half, seg_sum):
        return aggregate_half(x, rel_all, et, half, n_pad, msg_dtype, seg_sum)

    return _gather_schedule(group, local)


def build_ring_blocks(half: GraphHalf, g_size: int, n_pad: int):
    """The ring's static blocks (``build_ring_blocks``): ``blocks[i, s]``
    holds rank ``i``'s local edge positions whose source lies in shard
    ``s``, padded to the longest block by repeating its last entry (dst
    stays non-decreasing), and ``mask[i, s]`` is 1 on real entries.
    Returns int32 / float32 numpy arrays of shape ``(G, G, B_max)``."""
    src = half.src.cpu().numpy()
    e_pad = src.shape[0]
    if e_pad % g_size or n_pad % g_size:
        raise ValueError(f"{g_size} shards must divide {e_pad} edges and "
                         f"{n_pad} rows")
    e_loc, rows_per = e_pad // g_size, n_pad // g_size
    per_dev, b_max = [], 1
    for i in range(g_size):
        shard = np.minimum(src[i * e_loc: (i + 1) * e_loc] // rows_per,
                           g_size - 1)
        idxs = [np.nonzero(shard == s)[0].astype(np.int32)
                for s in range(g_size)]
        per_dev.append(idxs)
        b_max = max(b_max, max(len(ix) for ix in idxs))
    blocks = np.zeros((g_size, g_size, b_max), np.int32)
    mask = np.zeros((g_size, g_size, b_max), np.float32)
    for i, idxs in enumerate(per_dev):
        for s, ix in enumerate(idxs):
            if len(ix):
                blocks[i, s, :len(ix)] = ix
                blocks[i, s, len(ix):] = ix[-1]
                mask[i, s, :len(ix)] = 1.0
    return blocks, mask


def make_ring_aggregate(group, n_pad: int, compose: Callable = mult_compose):
    """The ring schedule (``make_ring_aggregate``): returns ``agg(x_local,
    rel_all, etabs, halves, rings) -> [(n_pad / G, d_msg) per half]``, where
    ``rings`` holds per half this rank's ``(blocks (G, B), mask (G, B))``
    of :func:`build_ring_blocks`.  At step t rank i holds shard
    ``(i - t) mod G``, composes its block's messages and sums them into an
    ``(n_pad, d_msg)`` accumulator; the accumulator's width is the
    compose's output width (``B·d_in`` for R-GCN)."""

    def agg(x_local: torch.Tensor, rel_all: torch.Tensor, etabs,
            halves: Sequence[GraphHalf], rings) -> List[torch.Tensor]:
        g, i = group_size(group), group_rank(group)
        rows_per = n_pad // g
        (rel_all,) = copy_to_group(group, rel_all)
        accs = [None] * len(halves)
        x_buf = x_local
        for t in range(g):
            s = (i - t) % g
            for h, (et, half, (blocks, mask)) in enumerate(
                    zip(etabs, halves, rings)):
                idx = blocks[s].long()
                # an empty block's padding entries (mask 0) may point at
                # another shard's sources: any row of the buffer serves
                loc = (half.src[idx].long() - s * rows_per).clamp(
                    0, rows_per - 1)
                msg = compose(x_buf[loc],
                              rel_all, half.rel[idx].long(),
                              None if et is None else et[idx],
                              half.norm[idx] * mask[s])
                acc = accs[h]
                if acc is None:
                    acc = torch.zeros(n_pad, msg.shape[1], dtype=msg.dtype,
                                      device=msg.device)
                accs[h] = acc.index_add(0, half.dst[idx].long(), msg)
            if t + 1 < g:
                (x_buf,) = ppermute([x_buf], [1], group)
        out = reduce_scatter_rows(torch.cat(accs, dim=1), group)
        return list(out.split(accs[0].shape[1], dim=1))

    return agg
