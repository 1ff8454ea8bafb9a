"""Boundary-compressed entity exchange (``--entity_sharded boundary``; the
counterpart of ``kgc_gcn_tpu/parallel/boundary.py``).

The ``gather`` schedule moves every entity row twice per layer and half (an
all_gather of x, a reduce-scatter of the aggregate); the ``ring`` moves all
N rows around the group.  A rank's edges, though, READ only the sources they
reference and WRITE only the dst rows of their contiguous dst-sorted slice,
so this schedule exchanges exactly those rows.  The graph is static, so the
boundary sets are built once on the host (:func:`build_boundary_plan`):

  * input side: ``U[i][s]``, the sorted unique source rows that rank ``i``'s
    edges read from shard ``s``.  At step ``t`` rank ``s`` sends
    ``U[(s+t) % G][s]`` (a compact gather of its own rows) to rank
    ``(s+t) % G`` by a shift-``t`` ``ppermute``; every input transfer is
    issued, in one batch, before any block is computed.  A rank's edges are
    grouped by source shard into static blocks whose source indices point
    into the compact received buffers.
  * output side: each rank sums into its unique local dst rows only (a
    ``(d_max, d)`` accumulator), adds the rows it owns into its own output
    block, and sends the rows owned by shard ``(i+k) % G`` there by a
    shift-``k`` ``ppermute``, where they are added in.

Every exchange step keeps its own size (the per-``t`` / per-``k`` maximum
over ranks), not one global maximum.  The plan holds numpy arrays with a
leading rank axis, field for field the JAX package's ``BoundaryPlan``;
:func:`make_boundary_aggregate` takes one rank's row of each onto its
device.  Its two forms: the plain compose and ``index_add_`` per block
(any compose), or K1 per block over ``d_max`` rows through
``ops/scatter.py:aggregate_half``, each block a ``GraphHalf`` of its own
(its entries are an increasing subset of a dst-sorted slice, so their
compressed dst ids do not decrease), with the block's src-sorted view for
d_x and its rel-sorted view for d_rel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from kgc_gcn_torch.data.graph import GraphHalf
from kgc_gcn_torch.ops.scatter import aggregate_half
from kgc_gcn_torch.ops.segment_sum import segment_sum
from kgc_gcn_torch.parallel.distributed import group_rank, ppermute


@dataclass(frozen=True)
class BoundaryPlan:
    """Static per-rank exchange metadata; every array has a leading (G,)
    axis, and the per-step ones live in tuples indexed like ``t_steps`` /
    ``k_steps``, each sized for its own step."""

    blk0: np.ndarray        # int32 (G, B0) local edge positions, padded by
                            #   repeating the last entry (dst stays sorted)
    blk0_mask: np.ndarray   # f32 (G, B0)
    loc0: np.ndarray        # int32 (G, B0) src - i*rows_per (into x_local)
    blk_t: tuple            # per t: int32 (G, B_e[t]) edges with src in
                            #   shard (i - t) % G
    blk_mask_t: tuple       # per t: f32 (G, B_e[t])
    loc_t: tuple            # per t: int32 (G, B_e[t]) rows of the received
                            #   buffer
    send_t: tuple           # per t: int32 (G, B_max[t]) local rows rank i
                            #   sends at step t to rank (i + t) % G
    dst_loc: np.ndarray     # int32 (G, E_loc) each local edge's row in the
                            #   rank's unique-dst space
    self_pos: np.ndarray    # int32 (G, S0) accumulator rows owned locally
    self_dst: np.ndarray    # int32 (G, S0) their local output rows
    self_mask: np.ndarray   # f32 (G, S0)
    out_send_k: tuple       # per k: int32 (G, S[k]) accumulator rows sent
                            #   at output step k to rank (i + k) % G
    out_mask_k: tuple       # per k: f32 (G, S[k])
    recv_pos_k: tuple       # per k: int32 (G, S[k]) the receiver's output
                            #   rows of step k's arrivals
    # each block's CSR for K1: dst ids per entry, row pointers over d_max,
    # and the block sorted by its buffer row for the backward's d_x
    seg0: np.ndarray        # int32 (G, B0)
    indptr0: np.ndarray     # int32 (G, d_max + 1)
    sperm0: np.ndarray      # int32 (G, B0) argsort of loc0
    sloc0: np.ndarray       # int32 (G, B0) loc0[sperm0]
    s_indptr0: np.ndarray   # int32 (G, rows_per + 1)
    seg_t: tuple            # per t: int32 (G, B_e[t])
    indptr_t: tuple         # per t: int32 (G, d_max + 1)
    sperm_t: tuple          # per t: int32 (G, B_e[t])
    sloc_t: tuple           # per t: int32 (G, B_e[t])
    s_indptr_t: tuple       # per t: int32 (G, B_max[t] + 1)
    t_steps: tuple          # input steps with any traffic
    k_steps: tuple          # output steps with any traffic
    d_max: int              # compressed accumulator rows
    rows_per: int           # entity rows per rank (n_pad / G)


def build_boundary_plan(half: GraphHalf, g_size: int, n_pad: int
                        ) -> Tuple[BoundaryPlan, Dict[str, int]]:
    """The host-side boundary analysis of one direction half: ``(plan,
    stats)``, where ``stats`` counts the rows one rank ships per layer for
    this half (padded and real) beside what the gather schedule ships."""
    src = half.src.cpu().numpy()
    dst = half.dst.cpu().numpy()
    e_pad = int(src.shape[0])
    if e_pad % g_size or n_pad % g_size:
        raise ValueError(f"{g_size} ranks must divide {e_pad} edges and "
                         f"{n_pad} rows")
    e_loc = e_pad // g_size
    rows_per = n_pad // g_size
    G = g_size

    U = [[np.empty(0, np.int64)] * G for _ in range(G)]
    blocks = [[None] * G for _ in range(G)]
    uniq_d, inv_d = [], []
    for i in range(G):
        ls = src[i * e_loc: (i + 1) * e_loc]
        ld = dst[i * e_loc: (i + 1) * e_loc]
        u, inv = np.unique(ld, return_inverse=True)
        uniq_d.append(u)
        inv_d.append(inv.astype(np.int32))
        sh = np.minimum(ls // rows_per, G - 1)
        for t in range(G):
            s = (i - t) % G
            pos = np.nonzero(sh == s)[0].astype(np.int32)
            blocks[i][t] = pos
            if t:
                U[i][s] = np.unique(ls[pos])

    t_steps = tuple(t for t in range(1, G)
                    if any(len(U[i][(i - t) % G]) for i in range(G)))
    d_max = max(1, max(len(u) for u in uniq_d))

    def fill_block(t, b_e, n_buf):
        """A block's arrays and its CSR / sort metadata.  Padding entries
        repeat the last real entry (mask 0), so ``seg`` stays
        non-decreasing and ``loc`` lands on a real buffer row."""
        blk = np.zeros((G, b_e), np.int32)
        mask = np.zeros((G, b_e), np.float32)
        loc = np.zeros((G, b_e), np.int32)
        seg = np.zeros((G, b_e), np.int32)
        indptr = np.zeros((G, d_max + 1), np.int32)
        sperm = np.zeros((G, b_e), np.int32)
        sloc = np.zeros((G, b_e), np.int32)
        s_indptr = np.zeros((G, n_buf + 1), np.int32)
        for i in range(G):
            pos = blocks[i][t]
            n = len(pos)
            if not n:
                continue
            blk[i, :n] = pos
            blk[i, n:] = pos[-1]
            mask[i, :n] = 1.0
            ls_blk = src[i * e_loc + pos]
            lo = (ls_blk - i * rows_per if t == 0
                  else np.searchsorted(U[i][(i - t) % G], ls_blk))
            loc[i, :n] = lo
            loc[i, n:] = lo[-1]
            ids = inv_d[i][pos]
            seg[i, :n] = ids
            seg[i, n:] = ids[-1]
            indptr[i] = np.searchsorted(seg[i], np.arange(d_max + 1), "left")
            order = np.argsort(loc[i], kind="stable").astype(np.int32)
            sperm[i] = order
            sloc[i] = loc[i][order]
            s_indptr[i] = np.searchsorted(sloc[i], np.arange(n_buf + 1),
                                          "left")
        return blk, mask, loc, seg, indptr, sperm, sloc, s_indptr

    b0 = max(1, max(len(blocks[i][0]) for i in range(G)))
    (blk0, blk0_mask, loc0, seg0, indptr0,
     sperm0, sloc0, s_indptr0) = fill_block(0, b0, rows_per)

    per_t = {k: [] for k in ("blk", "mask", "loc", "seg", "indptr", "sperm",
                             "sloc", "s_indptr", "send")}
    for t in t_steps:
        b_e = max(1, max(len(blocks[i][t]) for i in range(G)))
        b_max = max(1, max(len(U[(i + t) % G][i]) for i in range(G)))
        for key, a in zip(("blk", "mask", "loc", "seg", "indptr", "sperm",
                           "sloc", "s_indptr"), fill_block(t, b_e, b_max)):
            per_t[key].append(a)
        send = np.zeros((G, b_max), np.int32)
        for i in range(G):
            u = U[(i + t) % G][i]
            if len(u):
                send[i, :len(u)] = u - i * rows_per
        per_t["send"].append(send)

    # output routing: each rank's unique dst rows grouped by owner offset
    koffs = [((uniq_d[i] // rows_per) - i) % G for i in range(G)]
    s0 = max(1, max(int(np.sum(k == 0)) for k in koffs))
    k_counts = {k: max(int(np.sum(koffs[i] == k)) for i in range(G))
                for k in range(1, G)}
    k_steps = tuple(k for k in range(1, G) if k_counts[k])

    self_pos = np.zeros((G, s0), np.int32)
    self_dst = np.zeros((G, s0), np.int32)
    self_mask = np.zeros((G, s0), np.float32)
    in_rows = np.zeros(G, np.int64)    # real boundary rows received
    out_rows = np.zeros(G, np.int64)   # real accumulator rows sent
    for i in range(G):
        p = np.nonzero(koffs[i] == 0)[0].astype(np.int32)
        self_pos[i, :len(p)] = p
        self_dst[i, :len(p)] = uniq_d[i][p] - i * rows_per
        self_mask[i, :len(p)] = 1.0
        in_rows[i] = sum(len(U[i][s]) for s in range(G))
    out_send_k, out_mask_k, recv_pos_k = [], [], []
    for k in k_steps:
        s_max = k_counts[k]
        o_send = np.zeros((G, s_max), np.int32)
        o_mask = np.zeros((G, s_max), np.float32)
        r_pos = np.zeros((G, s_max), np.int32)
        for i in range(G):
            p = np.nonzero(koffs[i] == k)[0].astype(np.int32)
            if not len(p):
                continue
            o_send[i, :len(p)] = p
            o_mask[i, :len(p)] = 1.0
            r = (i + k) % G
            r_pos[r, :len(p)] = uniq_d[i][p] - r * rows_per
            out_rows[i] += len(p)
        out_send_k.append(o_send)
        out_mask_k.append(o_mask)
        recv_pos_k.append(r_pos)

    plan = BoundaryPlan(
        blk0=blk0, blk0_mask=blk0_mask, loc0=loc0,
        blk_t=tuple(per_t["blk"]), blk_mask_t=tuple(per_t["mask"]),
        loc_t=tuple(per_t["loc"]), send_t=tuple(per_t["send"]),
        dst_loc=np.stack(inv_d), self_pos=self_pos, self_dst=self_dst,
        self_mask=self_mask, out_send_k=tuple(out_send_k),
        out_mask_k=tuple(out_mask_k), recv_pos_k=tuple(recv_pos_k),
        seg0=seg0, indptr0=indptr0, sperm0=sperm0, sloc0=sloc0,
        s_indptr0=s_indptr0, seg_t=tuple(per_t["seg"]),
        indptr_t=tuple(per_t["indptr"]), sperm_t=tuple(per_t["sperm"]),
        sloc_t=tuple(per_t["sloc"]), s_indptr_t=tuple(per_t["s_indptr"]),
        t_steps=t_steps, k_steps=k_steps, d_max=d_max, rows_per=rows_per)
    stats = {
        "n_pad": n_pad,
        "rows_per": rows_per,
        # what one rank ships per layer for this half
        "in_rows_real_max": int(in_rows.max()),
        "in_rows_padded": int(sum(s.shape[1] for s in per_t["send"])),
        "out_rows_real_max": int(out_rows.max()),
        "out_rows_padded": int(sum(s.shape[1] for s in out_send_k)),
        # the gather schedule: the all_gather receives (G-1)/G of n_pad rows
        # and the reduce-scatter ships as many
        "gather_rows": 2 * (G - 1) * n_pad // G,
        "d_max": d_max,
    }
    return plan, stats


def _block_half(half: GraphHalf, blk, mask, loc, seg, indptr, sperm, sloc,
                s_indptr, device) -> GraphHalf:
    """One block of a rank's local half as a ``GraphHalf`` over ``d_max``
    rows: src the rows of its source buffer, dst its compressed dst ids, the
    norm masked on padding entries, its buffer-sorted and rel-sorted
    views."""
    e = torch.from_numpy(blk).long()
    t32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    rel = half.rel.cpu()[e].contiguous()
    norm = (half.norm.cpu()[e] * torch.from_numpy(mask)).contiguous()
    sp = torch.from_numpy(sperm).long()
    n_rel_rows = half.r_indptr.shape[0] - 1
    r = rel.numpy()
    rorder = np.argsort(r, kind="stable")
    return GraphHalf(
        src=t32(loc), dst=t32(seg), rel=rel, eid=half.eid.cpu()[e], norm=norm,
        indptr=t32(indptr), sperm=t32(sperm), s_indptr=t32(s_indptr),
        s_src=t32(sloc), s_dst=t32(seg)[sp], s_norm=norm[sp], s_rel=rel[sp],
        rperm=t32(rorder), r_indptr=t32(np.concatenate(
            [[0], np.cumsum(np.bincount(r, minlength=n_rel_rows))])),
        r_rel=t32(r[rorder]), e_real=int(mask.sum())).to(device)


class _BoundaryAggregate:
    """One half's boundary schedule on one rank (``make_boundary_aggregate``)."""

    def __init__(self, group, plan: BoundaryPlan, half: GraphHalf,
                 use_kernel: bool, msg_dtype: str,
                 compose: Optional[Callable], rank: Optional[int]):
        if use_kernel and compose is not None:
            raise ValueError("the boundary kernel path composes "
                             "multiplicatively; a custom compose needs "
                             "use_pallas=False")
        from kgc_gcn_torch.parallel.edge_parallel import mult_compose
        self.group, self.plan = group, plan
        self.use_kernel, self.msg_dtype = use_kernel, msg_dtype
        self.compose = compose or mult_compose
        i = group_rank(group) if rank is None else rank
        dev = half.src.device
        row = lambda a: torch.from_numpy(np.ascontiguousarray(a[i])).to(dev)
        self.send = [row(a).long() for a in plan.send_t]
        # (block GraphHalf, its local edge positions) per source buffer
        parts = [(plan.blk0, plan.blk0_mask, plan.loc0, plan.seg0,
                  plan.indptr0, plan.sperm0, plan.sloc0, plan.s_indptr0)]
        parts += list(zip(plan.blk_t, plan.blk_mask_t, plan.loc_t,
                          plan.seg_t, plan.indptr_t, plan.sperm_t,
                          plan.sloc_t, plan.s_indptr_t))
        self.blocks = [(_block_half(half, *(a[i] for a in arrays), dev),
                        row(arrays[0]).long()) for arrays in parts]
        self.self_pos, self.self_dst = (row(plan.self_pos).long(),
                                        row(plan.self_dst).long())
        self.self_mask = row(plan.self_mask)[:, None]
        self.out = [(row(s).long(), row(m)[:, None], row(r).long())
                    for s, m, r in zip(plan.out_send_k, plan.out_mask_k,
                                       plan.recv_pos_k)]

    def _block(self, xbuf, rel_all, etab, bh: GraphHalf, e, seg_sum):
        et = None if etab is None else etab[e]
        d_max = self.plan.d_max
        if self.use_kernel:
            return aggregate_half(xbuf, rel_all, et, bh, d_max,
                                  self.msg_dtype, seg_sum)
        msg = self.compose(xbuf[bh.src.long()], rel_all, bh.rel.long(), et,
                           bh.norm)
        return torch.zeros(d_max, msg.shape[1], dtype=msg.dtype,
                           device=msg.device).index_add(0, bh.dst.long(), msg)

    def __call__(self, x_local: torch.Tensor, rel_all: torch.Tensor,
                 etab: Optional[torch.Tensor],
                 seg_sum: Callable = segment_sum) -> torch.Tensor:
        plan = self.plan
        # every boundary-row transfer first, in one batch: each depends
        # only on x_local
        bufs = ppermute([x_local[s] for s in self.send], plan.t_steps,
                        self.group)
        acc = None
        for xbuf, (bh, e) in zip([x_local] + bufs, self.blocks):
            part = self._block(xbuf, rel_all, etab, bh, e, seg_sum)
            acc = part if acc is None else acc + part
        # the compressed rows to their owner shards
        out = torch.zeros(plan.rows_per, acc.shape[1], dtype=acc.dtype,
                          device=acc.device).index_add(
            0, self.self_dst, acc[self.self_pos] * self.self_mask)
        recvs = ppermute([acc[s] * m for s, m, _ in self.out], plan.k_steps,
                         self.group)
        for (_, _, pos), got in zip(self.out, recvs):
            out = out.index_add(0, pos, got)
        return out


def make_boundary_aggregate(group, plan: BoundaryPlan, half: GraphHalf,
                            use_kernel: bool = False,
                            msg_dtype: str = "float32",
                            compose: Optional[Callable] = None,
                            rank: Optional[int] = None) -> _BoundaryAggregate:
    """This rank's boundary aggregate of one half: ``agg(x_local, rel_all,
    etab, seg_sum) -> (rows_per, d_msg)`` of the rank's rows, where
    ``etab`` is the rank's slice of the half's per-edge table (or None).
    ``half`` is the rank's local slice of the half on its device
    (``edge_parallel.local_half``), ``plan`` the whole half's
    :func:`build_boundary_plan`, ``rank`` the rank in ``group`` whose plan
    row to take (default: this process's).  ``use_kernel`` runs each block
    on K1 (MGCN's multiplicative compose); otherwise ``compose`` runs per
    block with ``index_add_``."""
    return _BoundaryAggregate(group, plan, half, use_kernel, msg_dtype,
                              compose, rank)
