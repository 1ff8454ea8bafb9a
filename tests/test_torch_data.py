"""The port's host data layer against the JAX package's, exactly: vocab,
sr2o label sets, eval banks and every GraphHalf field
(kgc_gcn_torch/data/{dataset,graph,batching}.py)."""

import dataclasses

import numpy as np
import pytest

from kgc_gcn_tpu.data import batching as jbatch
from kgc_gcn_tpu.data import dataset as jdata
from kgc_gcn_tpu.data import graph as jgraph

from kgc_gcn_torch.data import batching as pbatch
from kgc_gcn_torch.data import dataset as pdata
from kgc_gcn_torch.data import graph as pgraph
from kgc_gcn_torch.data.toy import toy_triples


def _corpus(name):
    """(train, valid, test) name triples: Toy, or ~500 entities from numpy."""
    if name == "toy":
        return toy_triples(n_ent=12, n_rel=4, n_train=40)
    rng = np.random.default_rng(5)
    n_ent, n_rel = 500, 7
    split = lambda n: [(f"E{s}", f"Rel{r}", f"E{o}") for s, r, o in zip(
        rng.integers(n_ent, size=n), rng.integers(n_rel, size=n),
        rng.integers(n_ent, size=n))]
    return split(2000), split(150), split(150)


def _assert_labels_equal(a, b):
    assert [list(x) for x in a] == [list(x) for x in b]


@pytest.mark.parametrize("corpus", ["toy", "synth500"])
def test_dataset_graph_and_banks_equal_jax(corpus):
    train, valid, test = _corpus(corpus)
    jds = jdata.build_dataset(corpus, train, valid, test)
    pds = pdata.build_dataset(corpus, train, valid, test)

    assert pds.entity2id == jds.entity2id
    assert pds.relation2id == jds.relation2id
    for f in ("num_entity", "num_relation", "num_edge"):
        assert getattr(pds, f) == getattr(jds, f)
    for f in ("train_triples", "valid_triples", "test_triples",
              "train_queries"):
        np.testing.assert_array_equal(getattr(pds, f), getattr(jds, f))
    _assert_labels_equal(pds.train_labels, jds.train_labels)
    assert sorted(pds.eval_queries) == sorted(jds.eval_queries)
    for k, eq in jds.eval_queries.items():
        np.testing.assert_array_equal(pds.eval_queries[k].triples, eq.triples)
        _assert_labels_equal(pds.eval_queries[k].labels, eq.labels)

    pad_to = 8 if corpus == "toy" else pgraph.EDGE_PAD
    jg = jgraph.build_graph(jds.train_triples, jds.num_entity,
                            jds.num_relation, pad_to=pad_to)
    pg = pgraph.build_graph(pds.train_triples, pds.num_entity,
                            pds.num_relation, pad_to=pad_to)
    for f in ("n_ent", "n_rel", "n_edge", "e_pad", "num_messages"):
        assert getattr(pg, f) == getattr(jg, f)
    for half in ("inb", "outb"):
        jh, ph = getattr(jg, half), getattr(pg, half)
        assert ph.e_real == jh.e_real
        for f in dataclasses.fields(jgraph.GraphHalf):
            if f.name == "e_real":
                continue
            a = getattr(ph, f.name).numpy()
            b = np.asarray(getattr(jh, f.name))
            assert a.dtype == b.dtype, (half, f.name)
            np.testing.assert_array_equal(a, b, err_msg=f"{half}.{f.name}")

    jbanks = jbatch.make_banks(jds)
    pbanks = pbatch.make_banks(pds)
    assert sorted(pbanks) == sorted(jbanks)
    for k, pb in pbanks.items():
        assert (pb.n_queries, pb.n_ent) == (jbanks[k].n_queries, jbanks[k].n_ent)
        np.testing.assert_array_equal(pb.queries.numpy(),
                                      np.asarray(jbanks[k].queries))
        np.testing.assert_array_equal(pb.label_idx.numpy(),
                                      np.asarray(jbanks[k].label_idx))


def test_load_dataset_reads_the_same_files(tmp_path):
    from kgc_gcn_torch.data.toy import write_toy
    write_toy(str(tmp_path), "Toy")
    jds = jdata.load_dataset("Toy", str(tmp_path))
    pds = pdata.load_dataset("Toy", str(tmp_path))
    assert pds.entity2id == jds.entity2id
    np.testing.assert_array_equal(pds.test_triples, jds.test_triples)


def test_edge_table_reference_order_round_trip():
    train, valid, test = _corpus("toy")
    pds = pdata.build_dataset("toy", train, valid, test)
    jds = jdata.build_dataset("toy", train, valid, test)
    pg = pgraph.build_graph(pds.train_triples, pds.num_entity,
                            pds.num_relation, pad_to=8)
    jg = jgraph.build_graph(jds.train_triples, jds.num_entity,
                            jds.num_relation, pad_to=8)
    ref = np.random.default_rng(1).normal(size=(2 * pg.n_edge, 3)).astype(
        np.float32)
    tab = pgraph.edge_table_from_reference_order(ref, pg)
    np.testing.assert_array_equal(
        tab, jgraph.edge_table_from_reference_order(ref, jg))
    np.testing.assert_array_equal(
        pgraph.edge_table_to_reference_order(tab, pg), ref)


def test_padding_edges_and_padded_count():
    assert pgraph.EDGE_PAD == jgraph.EDGE_PAD == 512
    for e in (1, 511, 512, 513, 86835, 272115):
        assert pgraph.padded_edge_count(e) == jgraph.padded_edge_count(e)
    assert pgraph.padded_edge_count(86835) == 87040
    assert pgraph.padded_edge_count(272115) == 272384
    train, valid, test = _corpus("toy")
    pds = pdata.build_dataset("toy", train, valid, test)
    g = pgraph.build_graph(pds.train_triples, pds.num_entity,
                           pds.num_relation, pad_to=8)
    h = g.inb
    pad = slice(h.e_real, None)
    assert g.e_pad > h.e_real
    assert (h.dst[pad] == g.n_ent - 1).all()
    assert (h.norm[pad] == 0).all()
    assert (h.eid[pad] == 2 * g.n_edge).all()
    assert int(h.indptr[-1]) == g.e_pad
