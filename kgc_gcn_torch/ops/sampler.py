"""Edge sampling for stochastic subgraph training (BASELINE.json config 4;
the port's ``kgc_gcn_tpu/ops/sampler.py``).

Each training step draws K positions per direction half uniformly, with
replacement, among the half's real edges, on the device and from the
trainer's generator (no host RNG, static shapes), and rescales their norms by
E/K, so the aggregated neighbourhood sum stays unbiased:

    E[ (E/K) * sum_{k<K} m_{e_k} ] = sum_e m_e.

Sampling (``sample_half``) and aggregation (``aggregate_sampled_half``) are
apart, so that a caller can hand both packages the same positions: the two
random streams cannot match.  The sample is not dst-sorted, so it is summed
with ``index_add_``, as the JAX package sums it with XLA's unsorted
``segment_sum``; neither package has a kernel here.
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


def sample_half(generator: torch.Generator, half: GraphHalf, num_samples: int,
                n_edge_real: int) -> SampledHalf:
    """``num_samples`` uniform draws with replacement from the half's real
    edges, on the half's device (``sampler.py:sample_half``)."""
    idx = torch.randint(0, n_edge_real, (num_samples,), generator=generator,
                        device=half.src.device)
    return take_half(half, idx, n_edge_real)


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
