"""Decoder plumbing shared by the model families (the port's
``kgc_gcn_tpu/models/family_base.py:DecoderFamilyMixin``).

A family mixing this in has ``self.cfg``, a ``self.decoder`` module
(``models/decoders.py``: ``forward``, ``score_candidates``, ``ent_bias``,
and ``query`` where ``has_trunk``), and an
``encode(graph, train, rngs, kernels) -> (all_ent, all_rel)``.  Decoder state
(ConvE's BatchNorm statistics) lives in the decoder's buffers, so nothing is
threaded back out.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


class DecoderFamilyMixin:

    def decode(self, all_ent: torch.Tensor, all_rel: torch.Tensor,
               src: torch.Tensor, rel: torch.Tensor, train: bool = False,
               rngs: Optional[Dict[str, torch.Generator]] = None
               ) -> torch.Tensor:
        """(B,) query ids -> (B, N) logits over all entities."""
        return self.decoder(all_ent[src.long()], all_rel[rel.long()], all_ent,
                            train, rngs)

    def query_and_bias(self, all_ent: torch.Tensor, all_rel: torch.Tensor,
                       src: torch.Tensor, rel: torch.Tensor,
                       train: bool = False,
                       rngs: Optional[Dict[str, torch.Generator]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Decoder trunk only: (h (B, d), ent_bias (N,)) with logits ==
        h @ all_ent.T + ent_bias, for the sparse and fused losses."""
        h = self.decoder.query(all_ent[src.long()], all_rel[rel.long()],
                               train, rngs)
        return h, self.decoder.ent_bias

    def score_candidates(self, all_ent: torch.Tensor, all_rel: torch.Tensor,
                         src: torch.Tensor, rel: torch.Tensor,
                         cand: torch.Tensor, train: bool = False,
                         rngs: Optional[Dict[str, torch.Generator]] = None
                         ) -> torch.Tensor:
        """(B,) queries and (B, K) candidate ids -> (B, K) logits, through
        the decoder's own scorer (the JAX ``CANDIDATE_SCORERS``): the
        candidates' columns of the trunk's logits, or ``-||q - e_k||^2 +
        b_k`` for TransE and RotatE."""
        cand = cand.long()
        return self.decoder.score_candidates(
            all_ent[src.long()], all_rel[rel.long()], all_ent[cand], cand,
            train, rngs)

    def make_rngs(self, generator: torch.Generator
                  ) -> Dict[str, torch.Generator]:
        """The dropout sites of one step (``layer{i}`` after each encoder
        layer, ``feat``/``hidden`` in the decoder), each drawing from the
        trainer's one generator (a site missing here would silently not
        drop)."""
        names = tuple(f"layer{i}" for i in range(max(1, self.cfg.num_layers))
                      ) + ("feat", "hidden")
        return dict.fromkeys(names, generator)
