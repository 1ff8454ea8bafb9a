"""Edge-partitioned aggregation (the counterpart of
``kgc_gcn_tpu/parallel/edge_parallel.py``'s ``mult_compose``,
``make_sharded_aggregate``, ``make_local_agg``, ``build_local_csr`` and
``make_pallas_sharded_aggregate``).

Each rank of a data row holds a contiguous slice of each half's dst-sorted
edge list (``parallel/mesh.py:shard_graph``).  A slice of a dst-sorted list
is dst-sorted and covers a range of destination rows, so its CSR pointers are
the global ones clipped to the slice; the backward's src-sorted and
rel-sorted views are built per slice (``build_local_csr``).  A rank's slice
is a ``GraphHalf`` of its own (``local_half``), so every per-half operation of
the single-device path runs on it unchanged, into the full ``(N, d)`` rows.

The aggregate over the graph group is then:

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
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from kgc_gcn_torch.data.graph import GraphHalf
from kgc_gcn_torch.ops.scatter import aggregate_half
from kgc_gcn_torch.ops.segment_sum import segment_sum
from kgc_gcn_torch.parallel.distributed import copy_to_group, reduce_from_group


def mult_compose(x_rows, rel_all, rel_ids, et_rows, norm):
    """The MGCN message ``(x[src] * rel_all[rel] * etab) * norm``
    (reference model.py:111-118): the default compose of
    ``make_sharded_aggregate``, whose composes take ``(x_rows (E, d_in),
    rel_all (replicated table), rel_ids (E,), et_rows (E, d) or None,
    norm (E,)) -> (E, d_msg)``."""
    return (x_rows * rel_all[rel_ids] * et_rows) * norm[:, None]


def _shard_csr(half: GraphHalf, g_size: int, i: int):
    """Shard ``i``'s local CSR: (indptr, sperm, s_src, s_indptr, rperm,
    r_rel, r_indptr), int32 numpy arrays."""
    src, rel = half.src.cpu().numpy(), half.rel.cpu().numpy()
    e_pad = src.shape[0]
    if e_pad % g_size:
        raise ValueError(f"{g_size} shards do not divide {e_pad} edges")
    e_loc = e_pad // g_size
    lo = i * e_loc
    n_rows = half.indptr.shape[0] - 1
    n_rel_rows = half.r_indptr.shape[0] - 1
    i32 = lambda a: np.asarray(a, np.int32)
    ptr = lambda ids, n: i32(np.concatenate(
        [[0], np.cumsum(np.bincount(ids, minlength=n))]))
    indptr = np.clip(half.indptr.cpu().numpy().astype(np.int64) - lo, 0,
                     e_loc)
    ls, lr = src[lo: lo + e_loc], rel[lo: lo + e_loc]
    order = np.argsort(ls, kind="stable")
    rorder = np.argsort(lr, kind="stable")
    return (i32(indptr), i32(order), i32(ls[order]), ptr(ls, n_rows),
            i32(rorder), i32(lr[rorder]), ptr(lr, n_rel_rows))


def build_local_csr(half: GraphHalf, g_size: int):
    """Per-shard CSR of the ``g_size`` contiguous slices of a dst-sorted
    half, as numpy arrays with a leading (G,) axis, the layout of the JAX
    package's ``build_local_csr``: ``indptr (G, N+1)`` (the global pointers
    clipped to the slice), ``sperm, s_src (G, E_loc)`` and ``s_indptr
    (G, N+1)`` (the slice sorted by src), ``rperm, r_rel (G, E_loc)`` and
    ``r_indptr (G, 2R+2)`` (the slice sorted by relation)."""
    shards = [_shard_csr(half, g_size, i) for i in range(g_size)]
    return tuple(np.stack(a) for a in zip(*shards))


def local_half(half: GraphHalf, g_size: int, rank: int) -> GraphHalf:
    """Shard ``rank``'s slice of a dst-sorted half as a ``GraphHalf`` of
    ``E_pad / g_size`` edges over the same N rows, with its local CSR, on
    the CPU."""
    half = half.to("cpu")
    e_loc = half.src.shape[0] // g_size
    lo, hi = rank * e_loc, (rank + 1) * e_loc
    indptr, sperm, s_src, s_indptr, rperm, r_rel, r_indptr = (
        torch.from_numpy(a) for a in _shard_csr(half, g_size, rank))
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

