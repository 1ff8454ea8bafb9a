"""Synthetic toy KG generator — the test/smoke fixture.

The reference ships a 6-entity/4-relation ``data/Toy`` fixture for CPU smoke
runs (reference data/Toy, SURVEY.md §4).  We generate ours: a small random KG
written in the same three-file TSV format, plus an in-memory variant for unit
tests.  A fixed seed makes it reproducible.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

Triple = Tuple[str, str, str]


def toy_triples(
    n_ent: int = 12,
    n_rel: int = 4,
    n_train: int = 40,
    n_valid: int = 8,
    n_test: int = 8,
    seed: int = 7,
) -> Tuple[List[Triple], List[Triple], List[Triple]]:
    """Random triples; every valid/test entity+relation also appears in train
    so filtered eval never meets an unseen id."""
    rng = np.random.default_rng(seed)

    def sample(n, seen=None):
        out, used = [], set()
        while len(out) < n:
            s, r, o = rng.integers(n_ent), rng.integers(n_rel), rng.integers(n_ent)
            if s == o or (s, r, o) in used or (seen and (s, r, o) in seen):
                continue
            used.add((s, r, o))
            out.append((f"e{s}", f"r{r}", f"e{o}"))
        return out, used

    # train must touch every entity/relation at least once
    train, used = sample(n_train)
    for i in range(n_ent):
        train.append((f"e{i}", f"r{rng.integers(n_rel)}",
                      f"e{(i + 1) % n_ent}"))
    for j in range(n_rel):
        train.append((f"e{rng.integers(n_ent)}", f"r{j}",
                      f"e{rng.integers(n_ent)}"))
    train = list(dict.fromkeys(train))
    used = set((int(s[1:]), int(r[1:]), int(o[1:])) for s, r, o in train)
    valid, vused = sample(n_valid, used)
    test, _ = sample(n_test, used | vused)
    return train, valid, test


def compositional_triples(
    n_ent: int = 48,
    offsets: Tuple[int, ...] = (1, 3),
    held_frac: float = 0.3,
    seed: int = 11,
) -> Tuple[List[Triple], List[Triple], List[Triple]]:
    """Ring-structured KG whose held-out triples are IMPLIED by train
    structure — an in-environment generalization target (the stand-in for the
    reference's WN18RR MRR >= 0.46 gate, README.md:9, which needs the real
    corpus this machine doesn't have).

    Entities sit on a ring; relation ``r_k`` maps ``e -> e + offsets[k]
    (mod N)`` — each relation is a rotation, so every relation is functional
    and compositional structure is exact (``r_1 = r_0^3`` when offsets=(1,3)).
    Train keeps ALL triples of the first relation (the ring generator) plus a
    random (1 - held_frac) subset of each derived relation; the held-out
    derived triples split evenly into valid/test.  A model that merely
    memorizes scores ~chance MRR (~2/N) on them; a model that learns the
    rotation structure ranks the single true object near the top — the
    learnability gate asserts val MRR >> chance (tests/test_generalization.py).
    """
    rng = np.random.default_rng(seed)
    t = lambda s, k, o: (f"e{s}", f"r{k}", f"e{o}")
    train: List[Triple] = [t(e, 0, (e + offsets[0]) % n_ent)
                           for e in range(n_ent)]
    held: List[Triple] = []
    for k, off in enumerate(offsets[1:], start=1):
        perm = rng.permutation(n_ent)
        n_held = int(round(held_frac * n_ent))
        for e in perm[n_held:]:
            train.append(t(e, k, (e + off) % n_ent))
        for e in perm[:n_held]:
            held.append(t(e, k, (e + off) % n_ent))
    rng.shuffle(held)
    half = len(held) // 2
    return train, held[:half], held[half:]


def write_compositional(data_dir: str, name: str = "SYNC", **kw) -> str:
    root = os.path.join(data_dir, name)
    os.makedirs(root, exist_ok=True)
    train, valid, test = compositional_triples(**kw)
    for split, triples in (("train", train), ("valid", valid), ("test", test)):
        with open(os.path.join(root, split + ".txt"), "w") as f:
            for s, r, o in triples:
                f.write(f"{s}\t{r}\t{o}\n")
    return root


def write_toy(data_dir: str, name: str = "Toy", **kw) -> str:
    root = os.path.join(data_dir, name)
    os.makedirs(root, exist_ok=True)
    train, valid, test = toy_triples(**kw)
    for split, triples in (("train", train), ("valid", valid), ("test", test)):
        with open(os.path.join(root, split + ".txt"), "w") as f:
            for s, r, o in triples:
                f.write(f"{s}\t{r}\t{o}\n")
    return root
