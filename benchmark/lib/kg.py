"""Degree-skewed knowledge graphs at a public dataset's counts, made from a
seed in memory (no file is written).

A traffic file names the counts (entities, relations, train / valid / test
triples) and the skew.  Entity popularity follows a Zipf law over ranks,
P(rank k) ∝ k^-s with s = 1 / (degree_exponent - 1), so that the degrees
have a power-law tail of that exponent; relation popularity follows a Zipf
law of ``relation_exponent``.  Subject, relation and object of a triple are
drawn independently in rank space; duplicates and self-loops are dropped and
drawn again until the counts are exact.

The structure (which ranks form the triples) comes from the traffic file's
``structure_seed`` and is the same for every run; ``--seed`` permutes the
entity ids, the relation ids and the order of each split.  So every seed
gives the same graph up to the names of its nodes: the same degrees, the
same label widths and the same work, in another order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

SPLITS = ("train", "valid", "test")


@dataclass
class KG:
    """Id triples (n, 3) int64 ``(subject, relation, object)`` per split,
    relation ids in [0, R) (the reverse relations R..2R-1 are the
    program's and the reference's own)."""

    n_ent: int
    n_rel: int
    triples: Dict[str, np.ndarray]

    @property
    def n_train(self) -> int:
        return len(self.triples["train"])


def _zipf_ranks(rng: np.random.Generator, n: int, s: float,
                size: int) -> np.ndarray:
    """``size`` ranks in [0, n) with P(k) ∝ (k + 1)^-s (inverse CDF)."""
    cdf = np.cumsum(np.arange(1, n + 1, dtype=np.float64) ** -s)
    cdf /= cdf[-1]
    return np.minimum(np.searchsorted(cdf, rng.random(size)), n - 1)


def structure(traffic: dict) -> np.ndarray:
    """The rank triples of all splits, train first, in draw order:
    (E + V + T, 3) int64, unique, no self-loop.  Depends on the traffic
    file alone."""
    c = traffic["counts"]
    n_ent, n_rel = c["entities"], c["relations"]
    need = c["train"] + c["valid"] + c["test"]
    s_ent = 1.0 / (traffic["degree_exponent"] - 1.0)
    s_rel = traffic["relation_exponent"]
    rng = np.random.default_rng(traffic["structure_seed"])
    keys = np.empty(0, np.int64)
    while len(keys) < need:
        m = int((need - len(keys)) * 1.25) + 1024
        s = _zipf_ranks(rng, n_ent, s_ent, m)
        r = _zipf_ranks(rng, n_rel, s_rel, m)
        o = _zipf_ranks(rng, n_ent, s_ent, m)
        k = ((s * n_rel + r) * n_ent + o)[s != o]
        keys = np.concatenate([keys, k])
        _, first = np.unique(keys, return_index=True)
        keys = keys[np.sort(first)]          # first occurrences, draw order
    keys = keys[:need]
    o = keys % n_ent
    r = keys // n_ent % n_rel
    s = keys // (n_ent * n_rel)
    return np.stack([s, r, o], axis=1)


def generate(traffic: dict, seed: int) -> KG:
    """The traffic file's graph under ``seed``'s naming and order."""
    c = traffic["counts"]
    ranks = structure(traffic)
    rng = np.random.default_rng([seed, 0x6B67])
    ent = rng.permutation(c["entities"]).astype(np.int64)
    rel = rng.permutation(c["relations"]).astype(np.int64)
    named = np.stack([ent[ranks[:, 0]], rel[ranks[:, 1]], ent[ranks[:, 2]]],
                     axis=1)
    triples, lo = {}, 0
    for split in SPLITS:
        part = named[lo:lo + c[split]]
        triples[split] = np.ascontiguousarray(part[rng.permutation(len(part))])
        lo += c[split]
    return KG(c["entities"], c["relations"], triples)


def stats(kg: KG) -> dict:
    """What the skew makes of the graph: the largest in-degree's share of
    the train triples, and the padded label width L_max of the train bank
    (unique (s, r) queries with reverse ones, each padded to the largest
    label set, rounded up to 8) and its bytes, Q x L_max x 4."""
    t = kg.triples["train"]
    s, r, o = t[:, 0], t[:, 1], t[:, 2]
    two_r = 2 * kg.n_rel
    q = np.concatenate([s * two_r + r, o * two_r + r + kg.n_rel])
    _, width = np.unique(q, return_counts=True)
    l_max = max(8, -(-int(width.max()) // 8) * 8)
    indeg = np.bincount(o, minlength=kg.n_ent)
    return {"train_queries": int(len(width)), "label_width_max": l_max,
            "train_bank_bytes": int(len(width)) * l_max * 4,
            "largest_in_degree_share": float(indeg.max() / len(t))}
