"""Edge sampling for stochastic subgraph training (BASELINE.json config 4;
the port's ``kgc_gcn_tpu/ops/sampler.py``).

Each training step draws K positions per direction half uniformly, with
replacement, among the half's real edges, on the device and from the
trainer's generator (no host RNG, static shapes), and rescales their norms by
E/K, so the aggregated neighbourhood sum stays unbiased:

    E[ (E/K) * sum_{k<K} m_{e_k} ] = sum_e m_e.

Sampling (``draw_positions``, ``take_half``) and aggregation
(``aggregate_sampled_half``) are apart, so that a caller can hand both
packages the same positions: the two random streams cannot match.  The
sample is not dst-sorted, so it is summed with ``index_add_``, as the JAX
package sums it with XLA's unsorted ``segment_sum``; neither package has a
kernel here.

Under a graph axis every rank draws the same K global positions (the
encoder's stream is the same on every rank) and keeps those in its edge
slice (``take_slice``), the others at weight 0, so that shapes stay static;
the ranks' sums add up to the one-process sample's, as under the JAX
package's GSPMD (``parallel/edge_parallel.py:
make_sampled_aggregate``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kgc_gcn_torch.data.graph import GraphHalf


class SampledHalf(NamedTuple):
    """K sampled edges of one half: their endpoints, relation, position in
    the half (``eid``, which indexes the half's positional edge-embedding
    slice) and norm rescaled by E/K."""
    src: torch.Tensor
    dst: torch.Tensor
    rel: torch.Tensor
    eid: torch.Tensor
    norm: torch.Tensor


def take_half(half: GraphHalf, idx: torch.Tensor,
              n_edge_real: int) -> SampledHalf:
    """The sample at positions ``idx`` (K,) among the half's real edges
    ``[0, n_edge_real)``, norms scaled by ``n_edge_real / K`` in float32."""
    idx = idx.long()
    scale = (torch.tensor(n_edge_real, dtype=torch.float32)
             / torch.tensor(idx.shape[0], dtype=torch.float32))
    return SampledHalf(half.src[idx], half.dst[idx], half.rel[idx], idx,
                       half.norm[idx] * scale.to(half.norm.device))


def take_slice(half: GraphHalf, idx: torch.Tensor, lo: int,
               n_edge_real: int) -> SampledHalf:
    """The part of the sample at global positions ``idx`` (K,) that lies in
    this rank's edge slice ``[lo, lo + E_loc)`` of a half (``half`` the
    slice, ``parallel.edge_parallel.local_half``): positions mapped to
    ``p - lo``, the others to 0 with norm 0; norms scaled by the global
    ``n_edge_real / K``."""
    e_loc = half.src.shape[0]
    pos = idx.long() - lo
    own = (pos >= 0) & (pos < e_loc)
    loc = torch.where(own, pos, torch.zeros_like(pos))
    s = take_half(half, loc, n_edge_real)
    return s._replace(norm=s.norm * own.to(s.norm.dtype))


def draw_positions(generator: torch.Generator, num_samples: int,
                   n_edge_real: int, device) -> torch.Tensor:
    """``num_samples`` uniform draws with replacement among a half's real
    edge positions ``[0, n_edge_real)``, on ``device``."""
    return torch.randint(0, n_edge_real, (num_samples,), generator=generator,
                         device=device)


def sample_half(generator: torch.Generator, half: GraphHalf, num_samples: int,
                n_edge_real: int) -> SampledHalf:
    """``num_samples`` uniform draws with replacement from the half's real
    edges, on the half's device (``sampler.py:sample_half``)."""
    return take_half(half, draw_positions(generator, num_samples,
                                          n_edge_real, half.src.device),
                     n_edge_real)


def aggregate_sampled_half(x: torch.Tensor, rel_all: torch.Tensor,
                           etab: torch.Tensor, sample: SampledHalf,
                           n_ent: int) -> torch.Tensor:
    """Compose ``x[src] * rel[rel] * etab[eid]`` scaled by the rescaled norm
    and sum it unsorted into ``(N, d)`` (``sampler.py:
    aggregate_sampled_half``); autograd gives the backward."""
    msg = (x[sample.src.long()] * rel_all[sample.rel.long()]
           * etab[sample.eid]) * sample.norm[:, None]
    out = torch.zeros(n_ent, msg.shape[1], dtype=msg.dtype, device=msg.device)
    return out.index_add(0, sample.dst.long(), msg)
