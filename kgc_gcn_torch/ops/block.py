"""Block-diagonal R-GCN aggregation (the port's ``kgc_gcn_tpu/models/
rgcn.py:_block_aggregate``, R-GCN's ``num_blocks > 0``).

Per edge e of one direction half, with ``W_r = blockdiag(W_r^1 .. W_r^B)``
and the message ``xs = x[src] · norm`` viewed as (B, d_in/B):

    out[dst_e, b·(d_out/B) : (b+1)·(d_out/B)] += xs[e, b] @ blocks[rel_e, b]

The weight varies per edge, so the per-edge product gathers each edge's
(B, d_in/B, d_out/B) blocks.  At BASELINE config 3's shape (272,384 edges a
half, B 10, 10 x 20 blocks) the whole gather is 2.2 GB a half, so the
products run over chunks of edges whose gather stays within
``BLOCK_CHUNK_BYTES``, and the backward recomputes each chunk's gather
instead of keeping it (the JAX package's edge-chunked ``lax.scan``).

The dst-order sum of the messages is one K1 launch; the backward's d_x sums
``d_xs · norm`` through the half's src-sorted view with K1 (no index
backward, which would sort), and d_blocks adds each chunk's outer products
into the relation rows with ``index_add_``.  The JAX package has no kernel
here.
"""

from __future__ import annotations

from typing import Callable

import torch

from kgc_gcn_torch.data.graph import GraphHalf

# Bytes of gathered block weights one chunk may hold.
BLOCK_CHUNK_BYTES = 64 * 2**20


def block_chunk(blocks: torch.Tensor) -> int:
    """Edges per chunk: as many as ``BLOCK_CHUNK_BYTES`` of their gathered
    (B, d_in/B, d_out/B) float32 blocks allow, at least one."""
    per_edge = blocks[0].numel() * blocks.element_size()
    return max(1, BLOCK_CHUNK_BYTES // per_edge)


class _BlockAggregate(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, blocks, half: GraphHalf, n_ent: int,
                seg_sum: Callable):
        _, nb, bin_, bout = blocks.shape
        e = half.src.shape[0]
        xs = (x[half.src.long()] * half.norm[:, None]).view(e, nb, 1, bin_)
        rel = half.rel.long()
        msg = torch.empty(e, nb, 1, bout, dtype=torch.float32,
                          device=x.device)
        step = block_chunk(blocks)
        for lo in range(0, e, step):
            hi = min(lo + step, e)
            torch.matmul(xs[lo:hi], blocks[rel[lo:hi]], out=msg[lo:hi])
        ctx.save_for_backward(x, blocks)
        ctx.half, ctx.seg_sum = half, seg_sum
        return seg_sum(msg.view(e, nb * bout), half.dst, half.indptr, n_ent)

    @staticmethod
    def backward(ctx, g):
        x, blocks = ctx.saved_tensors
        half, seg_sum = ctx.half, ctx.seg_sum
        _, nb, bin_, bout = blocks.shape
        e = half.src.shape[0]
        norm = half.norm[:, None]
        xs = (x[half.src.long()] * norm).view(e, nb, bin_, 1)
        gd = g[half.dst.long()].view(e, nb, 1, bout)
        rel = half.rel.long()
        d_xs = torch.empty(e, nb, 1, bin_, dtype=torch.float32,
                           device=x.device)
        d_blocks = torch.zeros_like(blocks)
        step = block_chunk(blocks)
        for lo in range(0, e, step):
            hi = min(lo + step, e)
            w = blocks[rel[lo:hi]]                       # (C, B, bin, bout)
            torch.matmul(gd[lo:hi], w.transpose(2, 3), out=d_xs[lo:hi])
            d_blocks.index_add_(0, rel[lo:hi],
                                torch.matmul(xs[lo:hi], gd[lo:hi]))
        contrib = d_xs.view(e, nb * bin_) * norm
        d_x = seg_sum(contrib[half.sperm.long()], half.s_src, half.s_indptr,
                      x.shape[0])
        return d_x, d_blocks, None, None, None


def block_aggregate(x: torch.Tensor, blocks: torch.Tensor, half: GraphHalf,
                    n_ent: int, seg_sum: Callable) -> torch.Tensor:
    """(N, d_in) entities and (2R, B, d_in/B, d_out/B) block weights ->
    (N, d_out) float32 aggregates of one direction half, differentiable in
    both; ``seg_sum`` is K1 or its plain version."""
    return _BlockAggregate.apply(x, blocks, half, n_ent, seg_sum)
