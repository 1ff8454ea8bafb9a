"""Serving: encode once, answer link-prediction queries (the port's
``kgc_gcn_tpu/serve.py``).

A ``Predictor`` runs the full-graph encoder ONCE (eval mode) and caches
``all_ent`` / ``all_rel`` on the device; each query batch is one decoder pass
and ``torch.topk``.  Known-true objects can be filtered through a padded
per-query index list, and entity/relation NAMES map through the dataset
vocab, with the ``<rel>_reverse`` ids for head prediction (reference
data_loader.py:73-74).

``python -m kgc_gcn_torch.cli --do_predict --predict_file queries.txt`` serves
a TSV of ``subject<TAB>relation`` lines from a checkpoint, one JSON line per
query with the top-K entities and scores.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kgc_gcn_torch.config import Config
from kgc_gcn_torch.data.graph import Graph
from kgc_gcn_torch.ops.ranking import mask_entities


class Predictor:
    """Encode-once link-prediction server for one model (its parameters
    already loaded and on the graph's device)."""

    @torch.no_grad()
    def __init__(self, cfg: Config, model, graph: Graph,
                 entity2id: Optional[Dict[str, int]] = None,
                 relation2id: Optional[Dict[str, int]] = None):
        self.cfg = cfg
        self.model = model
        self.graph = graph
        self.device = graph.device
        self.entity2id = entity2id or {}
        self.relation2id = relation2id or {}
        self.id2entity = {v: k for k, v in self.entity2id.items()}
        # serving never re-encodes
        self.all_ent, self.all_rel = model.encode(graph)

    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=self.device)

    # ---------------------------------------------------------------- queries

    @torch.no_grad()
    def top_k(
        self,
        src: np.ndarray,                  # int (B,) entity ids
        rel: np.ndarray,                  # int (B,) relation ids (r + R for
                                          #   head prediction)
        k: int = 10,
        filter_idx: Optional[np.ndarray] = None,   # (B, L) ids to exclude,
                                                   #   padded with n_ent
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (B, k), entity ids (B, k)) for the top-k objects."""
        logits = self.model.decode(self.all_ent, self.all_rel,
                                   self._ids(src), self._ids(rel))
        if filter_idx is not None:
            logits = mask_entities(logits, self._ids(filter_idx))
        scores, idx = torch.topk(logits, k, dim=1)
        return scores.cpu().numpy(), idx.cpu().numpy()

    @torch.no_grad()
    def score_triples(self, src, rel, obj) -> np.ndarray:
        """Scores of explicit (s, r, o) triples, (B,)."""
        logits = self.model.decode(self.all_ent, self.all_rel,
                                   self._ids(src), self._ids(rel))
        return logits.gather(1, self._ids(obj)[:, None])[:, 0].cpu().numpy()

    def export_tables(self, path: str) -> str:
        """Write the encoded entity/relation tables (+ vocab) to ``path`` as
        an .npz, for retrieval systems that need embeddings, not the encoder."""
        ents = np.empty(len(self.entity2id), dtype=object)
        for name, i in self.entity2id.items():
            ents[i] = name
        rels = np.empty(len(self.relation2id), dtype=object)
        for name, i in self.relation2id.items():
            rels[i] = name
        np.savez(
            path,
            entity_embeddings=self.all_ent.cpu().numpy(),
            relation_embeddings=self.all_rel.cpu().numpy(),
            entity_bias=self.model.decoder.ent_bias.detach().cpu().numpy(),
            entity_names=ents, relation_names=rels)
        return path

    # ------------------------------------------------------------ name-level

    def ent_id(self, name: str) -> int:
        try:
            return self.entity2id[name.lower()]
        except KeyError:
            raise KeyError(f"unknown entity {name!r} (vocab has "
                           f"{len(self.entity2id)} entities)") from None

    def rel_id(self, name: str) -> int:
        try:
            return self.relation2id[name.lower()]
        except KeyError:
            raise KeyError(
                f"unknown relation {name!r} (vocab: "
                f"{sorted(self.relation2id)[:10]}...)") from None

    def query_names(self, subject: str, relation: str, k: int = 10,
                    head: bool = False) -> List[Dict]:
        """Top-k object (or subject, ``head=True``) names for a name query;
        head prediction uses the reverse-relation id ``r + R``."""
        s = self.ent_id(subject)
        r = self.rel_id(relation)
        if head:
            r += self.graph.n_rel
        scores, idx = self.top_k(np.array([s]), np.array([r]), k)
        return [
            {"entity": self.id2entity.get(int(e), str(int(e))),
             "score": float(v)}
            for v, e in zip(scores[0], idx[0])
        ]


def serve_stream(predictor: Predictor, stream, k: int = 10):
    """Streaming serving: one ``subject relation [head]`` query per input
    line, one JSON line yielded per query (errors come back as
    ``{"error": ...}`` lines instead of ending the stream)."""
    for line in stream:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0].lower() in ("quit", "exit"):
            return
        if len(parts) < 2:
            yield json.dumps({"error": f"malformed query line {line!r} "
                                       "(want: subject relation [head])"})
            continue
        head = len(parts) > 2 and parts[2].lower() == "head"
        try:
            yield json.dumps({
                "subject": parts[0].lower(), "relation": parts[1].lower(),
                "head": head,
                "topk": predictor.query_names(parts[0], parts[1], k=k,
                                              head=head)})
        except KeyError as e:
            yield json.dumps({"error": str(e.args[0]) if e.args else str(e)})
        except Exception as e:   # keep the long-running stream alive
            yield json.dumps({"error": f"{type(e).__name__}: {e}"})


def serve_file(predictor: Predictor, path: str, k: int = 10,
               batch_size: int = 128) -> List[str]:
    """Serve a TSV of ``subject<TAB>relation`` queries in batches of
    ``batch_size``; returns JSON lines."""
    queries = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            if len(parts) < 2:
                raise ValueError(f"{path}: malformed query line {line!r}")
            queries.append((parts[0].lower(), parts[1].lower()))
    if not queries:
        return []

    src = np.array([predictor.ent_id(s) for s, _ in queries], np.int64)
    rel = np.array([predictor.rel_id(r) for _, r in queries], np.int64)
    out = []
    for lo in range(0, len(queries), batch_size):
        scores, idx = predictor.top_k(src[lo:lo + batch_size],
                                      rel[lo:lo + batch_size], k=k)
        for q in range(len(scores)):
            sub, rl = queries[lo + q]
            ranked = [
                {"entity": predictor.id2entity.get(int(e), str(int(e))),
                 "score": float(v)}
                for v, e in zip(scores[q], idx[q])
            ]
            out.append(json.dumps(
                {"subject": sub, "relation": rl, "topk": ranked}))
    return out
