"""The training graph as torch tensors (the port's ``kgc_gcn_tpu/data/graph.py``).

Built once on the host with numpy, then moved to a device with ``.to``:

  * the bidirectional edge list is split into its two halves up front — the
    "in" half is the original orientation ``(src → dst, rel)``, the "out" half
    the reversed orientation ``(dst → src, rel + R)`` (reference
    model.py:88-90, data_loader.py:144-145);
  * each half is sorted by destination (CSR order), so aggregation is a sorted
    segment-sum over ``indptr`` (``ops/segment_sum.py``);
  * the reference's degree norm is precomputed: degree counted over ROW
    occurrences of the half, indexed at both endpoints (model.py:72-80);
  * edge arrays are padded to a multiple of ``pad_to`` with zero-norm edges
    whose ``dst`` is ``n_ent - 1`` and whose ``eid`` is ``2E``.

Every field of the JAX ``GraphHalf`` is kept, including the src-order and
rel-order views that the backward pass will need, and the padded layout
matches the JAX graph's one to one, so the ``(2, E_pad, d)`` per-edge table
carries across without remapping.  ``Graph.stacked`` is the JAX package's
``GraphStacked``: both halves as one dst-sorted edge list over ``[0, 2N)``,
which the ``spmm_mode`` schedules ``stacked`` and ``stacked_xla`` aggregate.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

# per-half edge padding: the JAX package pads to max(256, its 512-edge kernel
# tile); the port keeps the same value so both edge tables line up
EDGE_PAD = 512


@dataclass(frozen=True)
class GraphHalf:
    """One direction of the bidirectional edge list, CSR-sorted by dst."""

    src: torch.Tensor       # int32 (E_pad,)
    dst: torch.Tensor       # int32 (E_pad,) — non-decreasing
    rel: torch.Tensor       # int32 (E_pad,) — relation id (out half: rel + R)
    eid: torch.Tensor       # int32 (E_pad,) — reference edge id; 2E on padding
    norm: torch.Tensor      # float32 (E_pad,) — degree norm; 0 on padding
    indptr: torch.Tensor    # int32 (N + 1,) — CSR row pointers over dst
    sperm: torch.Tensor     # int32 (E_pad,) — permutation making src sorted
    s_indptr: torch.Tensor  # int32 (N + 1,) — CSR row pointers over src[sperm]
    s_src: torch.Tensor     # int32 (E_pad,) — src[sperm]
    s_dst: torch.Tensor     # int32 (E_pad,) — dst[sperm]
    s_norm: torch.Tensor    # float32 (E_pad,) — norm[sperm]
    s_rel: torch.Tensor     # int32 (E_pad,) — rel[sperm]
    rperm: torch.Tensor     # int32 (E_pad,) — permutation sorting rel
    r_indptr: torch.Tensor  # int32 (2R + 2,) — CSR pointers over rel[rperm]
    r_rel: torch.Tensor     # int32 (E_pad,) — rel[rperm]
    e_real: int = 0         # unpadded edge count

    def to(self, device) -> "GraphHalf":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "e_real"})


@dataclass(frozen=True)
class GraphStacked:
    """Both direction halves as ONE edge list (``kgc_gcn_tpu/data/graph.py:
    GraphStacked``).

    The out-half's destination ids are offset by ``n_ent``, so the segment
    ids span ``[0, 2N)`` and the concatenation [in-half; out-half] of the two
    dst-sorted halves is globally dst-sorted.  Stacked position k is row k of
    the per-edge table viewed as ``(2 * E_pad, d)``."""

    src: torch.Tensor       # int32 (2*E_pad,) — source ids (both halves)
    dst2: torch.Tensor      # int32 (2*E_pad,) — dst + N * is_out_half; sorted
    rel: torch.Tensor       # int32 (2*E_pad,) — relation ids (out half: rel + R)
    norm: torch.Tensor      # float32 (2*E_pad,) — degree norms; 0 on padding
    indptr: torch.Tensor    # int32 (2N + 1,) — CSR pointers over dst2
    sperm: torch.Tensor     # int32 (2*E_pad,) — permutation sorting src (both
                            #   halves together: d_x sums over src globally)
    s_indptr: torch.Tensor  # int32 (N + 1,) — CSR pointers over src[sperm]
    s_src: torch.Tensor     # int32 (2*E_pad,) — src[sperm]
    rperm: torch.Tensor     # int32 (2*E_pad,) — rel-sorted permutation (d_rel)
    r_indptr: torch.Tensor  # int32 (2R + 2,)
    r_rel: torch.Tensor     # int32 (2*E_pad,) — rel[rperm]

    @property
    def dst(self) -> torch.Tensor:
        """``dst2``, under the name the per-half aggregation reads, so that
        ``ops/scatter.py:_Aggregate`` sums the stacked view over 2N rows."""
        return self.dst2

    def to(self, device) -> "GraphStacked":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


@dataclass(frozen=True)
class Graph:
    inb: GraphHalf       # original orientation (src, rel, dst)
    outb: GraphHalf      # reversed orientation (dst, rel + R, src)
    stacked: GraphStacked  # both halves as one dst-sorted edge list
    n_ent: int = 0
    n_rel: int = 0       # R; relation tables hold 2R (+1 loop)
    n_edge: int = 0      # E = true (unpadded) edges per half
    e_pad: int = 0       # padded edge count per half

    @property
    def num_messages(self) -> int:
        """Edges aggregated per forward pass (both halves + N self-loops)."""
        return 2 * self.n_edge + self.n_ent

    @property
    def device(self) -> torch.device:
        return self.inb.src.device

    def to(self, device) -> "Graph":
        return dataclasses.replace(self, inb=self.inb.to(device),
                                   outb=self.outb.to(device),
                                   stacked=self.stacked.to(device))


def padded_edge_count(n_edge: int, pad_to: int = EDGE_PAD) -> int:
    """Padded per-half edge count for a given real edge count."""
    return max(pad_to, -(-n_edge // pad_to) * pad_to)


def _reference_norm(row: np.ndarray, col: np.ndarray, n_ent: int) -> np.ndarray:
    """deg^-1/2[row] * deg^-1/2[col], degree over row occurrences only
    (reference model.py:72-80)."""
    deg = np.zeros(n_ent, dtype=np.float32)
    np.add.at(deg, row, 1.0)
    with np.errstate(divide="ignore"):
        dinv = deg ** -0.5
    dinv[np.isinf(dinv)] = 0.0
    return (dinv[row] * dinv[col]).astype(np.float32)


def _csr_pointers(idx: np.ndarray, n_rows: int) -> np.ndarray:
    ptr = np.zeros(n_rows + 1, dtype=np.int32)
    ptr[1:] = np.cumsum(np.bincount(idx, minlength=n_rows))
    return ptr


def _build_half(src, dst, rel, eid, n_ent: int, n_edge_total: int,
                n_rel_rows: int, pad_to: int) -> GraphHalf:
    e = len(src)
    norm = _reference_norm(src, dst, n_ent)
    order = np.argsort(dst, kind="stable")
    src, dst, rel, eid, norm = (a[order] for a in (src, dst, rel, eid, norm))

    pad = padded_edge_count(e, pad_to) - e
    if pad:
        # zero-norm padding contributes nothing to the segment sum; the eid
        # sentinel 2E keeps eid duplicate-free for the edge-table mappings
        src = np.concatenate([src, np.zeros(pad, src.dtype)])
        dst = np.concatenate([dst, np.full(pad, n_ent - 1, dst.dtype)])
        rel = np.concatenate([rel, np.zeros(pad, rel.dtype)])
        eid = np.concatenate([eid, np.full(pad, n_edge_total, eid.dtype)])
        norm = np.concatenate([norm, np.zeros(pad, norm.dtype)])

    sperm = np.argsort(src, kind="stable").astype(np.int32)
    rperm = np.argsort(rel, kind="stable").astype(np.int32)
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return GraphHalf(
        src=i32(src), dst=i32(dst), rel=i32(rel), eid=i32(eid), norm=f32(norm),
        indptr=i32(_csr_pointers(dst, n_ent)),    # padding lands in row N-1
        sperm=i32(sperm),
        s_indptr=i32(_csr_pointers(src, n_ent)),  # padding (src=0) in row 0
        s_src=i32(src[sperm]), s_dst=i32(dst[sperm]), s_norm=f32(norm[sperm]),
        s_rel=i32(rel[sperm]),
        rperm=i32(rperm), r_indptr=i32(_csr_pointers(rel, n_rel_rows)),
        r_rel=i32(rel[rperm]),
        e_real=e,
    )


def edge_table_to_reference_order(edge_tab, graph: Graph) -> np.ndarray:
    """Map a positionally-stored per-edge table ``(2, E_pad, d)`` to reference
    numbering ``(2E, d)`` (row i = reference edge id i; data_loader.py:148)."""
    tab = np.asarray(edge_tab)
    e_pad = graph.e_pad
    tab = tab.reshape(2 * e_pad, tab.shape[-1])
    out = np.zeros((2 * graph.n_edge, tab.shape[1]), tab.dtype)
    for half, base in ((graph.inb, 0), (graph.outb, e_pad)):
        eid = half.eid[: half.e_real].cpu().numpy()
        out[eid] = tab[base: base + half.e_real]
    return out


def edge_table_from_reference_order(ref_tab, graph: Graph) -> np.ndarray:
    """Inverse of :func:`edge_table_to_reference_order` (padding rows zero);
    returns the model's ``(2, E_pad, d)`` layout."""
    ref_tab = np.asarray(ref_tab)
    e_pad = graph.e_pad
    out = np.zeros((2 * e_pad, ref_tab.shape[1]), ref_tab.dtype)
    for half, base in ((graph.inb, 0), (graph.outb, e_pad)):
        eid = half.eid[: half.e_real].cpu().numpy()
        out[base: base + half.e_real] = ref_tab[eid]
    return out.reshape(2, e_pad, ref_tab.shape[1])


def build_graph(
    train_triples: np.ndarray,
    n_ent: int,
    n_rel: int,
    pad_to: int = EDGE_PAD,
) -> Graph:
    """Build the bidirectional training graph on the CPU (reference
    data_loader.py:132-157); move it with ``Graph.to(device)``.

    Edge ids: forward edge i gets id ``i``, its reverse ``E + i`` — the
    reference's ``arange(2E)`` over the concatenated list (data_loader.py:148).
    """
    tri = np.asarray(train_triples)
    src, rel, dst = (tri[:, i].astype(np.int32) for i in range(3))
    e = len(src)
    eid = np.arange(e, dtype=np.int32)
    n_rel_rows = 2 * n_rel + 1   # rel_all rows incl. the appended loop rel
    inb = _build_half(src, dst, rel, eid, n_ent, 2 * e, n_rel_rows, pad_to)
    outb = _build_half(dst, src, rel + n_rel, eid + e, n_ent, 2 * e,
                       n_rel_rows, pad_to)
    return Graph(inb=inb, outb=outb, stacked=_build_stacked(inb, outb, n_ent,
                                                            n_rel_rows),
                 n_ent=n_ent, n_rel=n_rel, n_edge=e,
                 e_pad=int(inb.src.shape[0]))


def _build_stacked(inb: GraphHalf, outb: GraphHalf, n_ent: int,
                   n_rel_rows: int) -> GraphStacked:
    """Concatenate the (already dst-sorted) halves, offsetting the
    out-half's dst by N: the result is globally sorted over [0, 2N)
    (``kgc_gcn_tpu/data/graph.py:278-297``)."""
    cat = lambda name: np.concatenate([getattr(inb, name).numpy(),
                                       getattr(outb, name).numpy()])
    src, rel, norm = cat("src"), cat("rel"), cat("norm")
    dst2 = np.concatenate([inb.dst.numpy(),
                           outb.dst.numpy() + n_ent]).astype(np.int32)
    sperm = np.argsort(src, kind="stable").astype(np.int32)
    rperm = np.argsort(rel, kind="stable").astype(np.int32)
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    return GraphStacked(
        src=i32(src), dst2=i32(dst2), rel=i32(rel),
        norm=torch.from_numpy(np.ascontiguousarray(norm, np.float32)),
        indptr=i32(_csr_pointers(dst2, 2 * n_ent)), sperm=i32(sperm),
        s_indptr=i32(_csr_pointers(src, n_ent)), s_src=i32(src[sperm]),
        rperm=i32(rperm), r_indptr=i32(_csr_pointers(rel, n_rel_rows)),
        r_rel=i32(rel[rperm]))
