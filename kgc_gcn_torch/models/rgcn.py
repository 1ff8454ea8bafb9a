"""R-GCN with basis-decomposed or block-diagonal relation weights + a
decoder (the port's ``kgc_gcn_tpu/models/rgcn.py``).

  * Per layer ``W_r = Σ_b coeff[r, b] · basis[b]``.  Because the projection is
    linear and the coefficients depend only on the relation, each direction
    half aggregates per basis FIRST, in ``d_in`` space, through kernel K7
    (``ops/basis.py``): ``agg[n, b·d_in + j] = Σ_{e into n} coeff[rel_e, b] ·
    norm_e · x[src_e, j]``; then one (N, B·d_in) × (B·d_in, d_out) product
    (a plain large matmul, as the JAX package leaves its einsum to XLA).
  * Block mode (``num_blocks`` B > 0): ``W_r = blockdiag(W_r^1 .. W_r^B)``
    with ``layers.{i}.blocks`` (2R, B, d_in/B, d_out/B); each half's
    per-edge products run over chunks of edges and are summed by K1
    (``ops/block.py``).  B must divide d_in and d_out.
  * ``h = agg_in + agg_out + x @ self_weight``, ReLU, then dropout
    ``layer{i}`` (every layer, the last included).
  * ``relation_embedding`` (2R, d_out) goes straight to the decoder.
  * Under a graph axis (``mesh.graph`` G > 1) the JAX package turns the
    kernel path off (``rgcn.py:205-220,313-314``): each rank composes its
    edge slice's messages in plain tensor ops (``basis_compose``: the
    (E, B·d_in) expansion; ``block_compose``: the per-edge block products),
    sums them with ``index_add_``, and one SUM over the graph group follows
    (``parallel/edge_parallel.py:make_sharded_aggregate``).

Parameters keep the JAX layout and names (``layers.{i}.basis`` is
``(B, d_in, d_out)``), so ``convert.py`` maps a JAX ``RGCNParams`` onto this
module by name.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from kgc_gcn_torch.config import Config
from kgc_gcn_torch.data.graph import Graph
from kgc_gcn_torch.models.common import dropout, xavier_uniform
from kgc_gcn_torch.models.decoders import build_decoder
from kgc_gcn_torch.models.family_base import DecoderFamilyMixin
from kgc_gcn_torch.ops import basis
from kgc_gcn_torch.ops.basis import basis_aggregate
from kgc_gcn_torch.ops.block import block_aggregate
from kgc_gcn_torch.ops.kernels import KERNELS, Kernels
from kgc_gcn_torch.parallel.edge_parallel import make_sharded_aggregate


def basis_compose(x_rows, coeff, rel_ids, et_rows, norm):
    """The (E, B·d_in) basis expansion ``a[e, b] · norm_e · x[src_e, :]``
    with ``a = coeff[rel]``, laid out as K7's output (``rgcn.py:
    basis_compose``); R-GCN has no per-edge table (``et_rows`` None)."""
    del et_rows
    a = coeff[rel_ids]
    msg = x_rows * norm[:, None]
    return (msg[:, None, :] * a[:, :, None]).reshape(msg.shape[0], -1)


def block_compose(x_rows, blocks, rel_ids, et_rows, norm):
    """Each edge's block products ``xs[e, b] @ blocks[rel_e, b]`` with
    ``xs = x[src] · norm`` viewed as (B, d_in/B) -> (E, d_out)
    (``ops/block.py``'s message, unchunked)."""
    del et_rows
    _, nb, bin_, bout = blocks.shape
    xs = (x_rows * norm[:, None]).view(-1, nb, 1, bin_)
    return torch.matmul(xs, blocks[rel_ids]).view(-1, nb * bout)


class RGCNLayer(nn.Module):
    """``RGCNLayerParams`` (``rgcn.py:40-46``, init ``:268-287``): basis and
    coefficients, or block weights, and the self-connection."""

    def __init__(self, mode: str, nb: int, n_rel2: int, d_in: int,
                 d_out: int, generator: torch.Generator):
        super().__init__()
        p = lambda *shape: nn.Parameter(xavier_uniform(shape, generator))
        if mode == "block":
            if d_in % nb or d_out % nb:
                raise ValueError(
                    f"num_blocks={nb} must divide dims ({d_in},{d_out})")
            self.blocks = p(n_rel2, nb, d_in // nb, d_out // nb)
        else:
            self.basis = p(nb, d_in, d_out)
            self.coeff = p(n_rel2, nb)
        self.self_weight = p(d_in, d_out)


class RGCN(DecoderFamilyMixin, nn.Module):
    """Model family 'rgcn' with any decoder (``cfg.decoder``);
    ``cfg.num_blocks`` > 0 selects block mode, else basis mode
    (``cfg.num_bases``, 0 for min(2R, 30))."""

    def __init__(self, cfg: Config, n_ent: int, n_rel: int, n_edge: int,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        self.mesh = mesh
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed % 2**32)
        self.cfg = cfg
        self.n_ent, self.n_rel, self.n_edge = n_ent, n_rel, n_edge
        n_rel2 = 2 * n_rel
        if cfg.num_blocks > 0:
            self.mode, self.nb = "block", cfg.num_blocks
        else:
            self.mode = "basis"
            self.nb = cfg.num_bases if cfg.num_bases > 0 else min(n_rel2, 30)
        d = cfg.gcn_in_dim
        layers = []
        for _ in range(max(1, cfg.num_layers)):
            layers.append(RGCNLayer(self.mode, self.nb, n_rel2, d,
                                    cfg.gcn_out_dim, generator))
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
        (``rgcn.py:300-362``); ``kernels`` selects K7/K8/K1 (block mode: K1)
        or their plain versions."""
        rngs = rngs or {}
        x = self.entity_embedding
        # KGC_BASIS_READBACK applies where the JAX package's band backward
        # runs: use_pallas, at most 128 bases (rgcn.py:prepare_kernels)
        readback = (torch.bfloat16 if self.cfg.use_pallas
                    and basis.BASIS_READBACK == "bf16"
                    and self.nb <= basis.BASIS_READBACK_MAX_BASES
                    else torch.float32)
        group = self._graph_group(graph)
        halves = (graph.inb, graph.outb)
        for i, layer in enumerate(self.layers):
            if self.mode == "block":
                if group is not None:
                    agg_in, agg_out = make_sharded_aggregate(
                        group, self.n_ent, block_compose)(
                            x, layer.blocks, (None, None), halves)
                else:
                    agg_in, agg_out = (block_aggregate(
                        x, layer.blocks, half, self.n_ent, kernels.seg_sum)
                        for half in halves)
            else:
                w = layer.basis.reshape(-1, layer.basis.shape[2])  # (B·d_in, d_out)
                if group is not None:
                    msgs = make_sharded_aggregate(
                        group, self.n_ent, basis_compose)(
                            x, layer.coeff, (None, None), halves)
                else:
                    msgs = (basis_aggregate(x, layer.coeff, half, self.n_ent,
                                            kernels, readback)
                            for half in halves)
                agg_in, agg_out = (torch.matmul(m, w) for m in msgs)
            h = agg_in + agg_out + x @ layer.self_weight
            x = dropout(torch.relu(h), self.cfg.gcn_drop, rngs.get(f"layer{i}"),
                        train)
        return x, self.relation_embedding
