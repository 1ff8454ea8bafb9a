"""The skewed graph generator: seeded, exact counts, the same structure
under every seed, and the statistics its traffic files record."""

import json

import numpy as np
import pytest

from conftest import BENCH, TOY_COUNTS

from benchmark.lib import kg

TOY = {"counts": TOY_COUNTS, "degree_exponent": 2.5, "relation_exponent": 1.0,
       "structure_seed": 0}


def test_same_seed_same_graph():
    a, b = kg.generate(TOY, 7), kg.generate(TOY, 7)
    for split in kg.SPLITS:
        assert np.array_equal(a.triples[split], b.triples[split])


def test_counts_exact_and_triples_valid():
    g = kg.generate(TOY, 2**31 + 5)
    assert (g.n_ent, g.n_rel) == (TOY_COUNTS["entities"], TOY_COUNTS["relations"])
    every = np.concatenate([g.triples[s] for s in kg.SPLITS])
    for split in kg.SPLITS:
        assert g.triples[split].shape == (TOY_COUNTS[split], 3)
    assert len(np.unique(every, axis=0)) == len(every)     # no duplicate
    assert (every[:, 0] != every[:, 2]).all()               # no self-loop
    assert every[:, [0, 2]].min() >= 0 and every[:, [0, 2]].max() < g.n_ent
    assert every[:, 1].min() >= 0 and every[:, 1].max() < g.n_rel


def test_seeds_rename_the_same_structure():
    a, b = kg.generate(TOY, 1), kg.generate(TOY, 2)
    assert not np.array_equal(a.triples["train"], b.triples["train"])
    assert kg.stats(a) == kg.stats(b)
    deg = lambda g: np.sort(np.bincount(g.triples["train"][:, 2],
                                        minlength=g.n_ent))
    assert np.array_equal(deg(a), deg(b))


def test_skew_is_zipf():
    ranks = kg._zipf_ranks(np.random.default_rng(0), 100, 1.0, 200_000)
    freq = np.bincount(ranks, minlength=100) / len(ranks)
    h = (1.0 / np.arange(1, 101)).sum()
    assert abs(freq[0] - 1 / h) < 0.01 and abs(freq[9] - 0.1 / h) < 0.005


@pytest.mark.parametrize("traffic", ["train.zipf-15k", "train.zipf-123k"])
def test_recorded_stats(traffic):
    t = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    got = kg.stats(kg.generate(t, 3))
    assert {k: t["stats"][k] for k in got} == got
