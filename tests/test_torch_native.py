"""The port's host data engine (kgc_gcn_torch/utils/native.py over
native/graphcore.cpp, and the ``use_native`` engines of
kgc_gcn_torch/data/{dataset,graph}.py) against the JAX package's numpy
engines and its own ctypes bridge (kgc_gcn_tpu/utils/native.py), exactly:
the parse, the half builder, both sr2o groupers and the locality order.
The port builds its own library into build/kgc_gcn_torch/, raises where the
build fails, and reaches numpy only when asked (``use_native=False``).
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from kgc_gcn_tpu.data import dataset as jdata
from kgc_gcn_tpu.data import graph as jgraph
from kgc_gcn_tpu.data.partition import _locality_order_numpy
from kgc_gcn_tpu.utils import native as jnative

from kgc_gcn_torch.data import dataset as pdata
from kgc_gcn_torch.data import graph as pgraph
from kgc_gcn_torch.data.toy import write_toy
from kgc_gcn_torch.utils import native

def _corpus_files(tmp_path, n_ent=40, n_rel=5, n=300, seed=0):
    """TSV files with mixed case and both separators: entity and relation
    names in first-seen order are lowercased by both engines."""
    rng = np.random.default_rng(seed)
    root = tmp_path / "Syn"
    root.mkdir()
    for split, m in (("train", n), ("valid", n // 10), ("test", n // 10)):
        lines = [f"Ent{s}\tREL_{r} e{o}" if i % 3 else f"ent{s} Rel_{r}\tE{o}"
                 for i, (s, r, o) in enumerate(zip(
                     rng.integers(n_ent, size=m), rng.integers(n_rel, size=m),
                     rng.integers(n_ent, size=m)))]
        (root / f"{split}.txt").write_text("\n".join(lines) + "\n\n")
    return root


def _assert_datasets_equal(a, b):
    assert a.entity2id == b.entity2id
    assert a.relation2id == b.relation2id
    for f in ("num_entity", "num_relation", "num_edge"):
        assert getattr(a, f) == getattr(b, f)
    for f in ("train_triples", "valid_triples", "test_triples",
              "train_queries"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert [list(x) for x in a.train_labels] == \
        [list(x) for x in b.train_labels]
    assert sorted(a.eval_queries) == sorted(b.eval_queries)
    for k, eq in b.eval_queries.items():
        np.testing.assert_array_equal(a.eval_queries[k].triples, eq.triples)
        assert [list(x) for x in a.eval_queries[k].labels] == \
            [list(x) for x in eq.labels]


@pytest.mark.parametrize("seed", [0, 1])
def test_parse_and_group_equal_jax_numpy_engine(tmp_path, seed):
    """load_dataset with the C++ engine equals the port's numpy engine and
    the JAX package's numpy engine, field for field."""
    root = _corpus_files(tmp_path, seed=seed)
    nat = pdata.load_dataset("Syn", str(tmp_path))
    _assert_datasets_equal(nat, pdata.load_dataset("Syn", str(tmp_path),
                                                   use_native=False))
    _assert_datasets_equal(nat, jdata.load_dataset("Syn", str(tmp_path),
                                                   use_native=False))
    assert any(c.isupper() for c in (root / "train.txt").read_text())
    assert all(k == k.lower() for k in nat.entity2id)


def test_bridge_equals_jax_bridge(tmp_path):
    """Every entry point against kgc_gcn_tpu.utils.native on the same
    inputs."""
    if jnative.get_lib() is None:
        pytest.skip("the JAX package's graphcore library did not build")
    _corpus_files(tmp_path)
    paths = [str(tmp_path / "Syn" / f"{s}.txt")
             for s in ("train", "valid", "test")]
    got, want = native.load_corpus_native(*paths), \
        jnative.load_corpus_native(*paths)
    assert got[0] == want[0] and got[1] == want[1]
    for s in want[2]:
        np.testing.assert_array_equal(got[2][s], want[2][s])
    tri = np.concatenate([got[2][s] for s in ("train", "valid", "test")])
    n_rel = len(got[1])
    for a, b in zip(native.group_sr2o_native(tri, n_rel),
                    jnative.group_sr2o_native(tri, n_rel)):
        np.testing.assert_array_equal(a, b)
    for ga, gb in zip(native.group_sr2o_splits_native(
            tri, len(got[2]["train"]), n_rel),
            jnative.group_sr2o_splits_native(
                tri, len(got[2]["train"]), n_rel)):
        for a, b in zip(ga, gb):
            np.testing.assert_array_equal(a, b)
    src, dst = tri[:, 0].astype(np.int32), tri[:, 2].astype(np.int32)
    n = len(got[0])
    for a, b in zip(native.build_half_native(src, dst, n),
                    jnative.build_half_native(src, dst, n)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(native.locality_order_native(src, dst, n),
                                  jnative.locality_order_native(src, dst, n))


@pytest.mark.parametrize("seed,n,e", [(0, 50, 400), (1, 300, 90)])
def test_half_builder_and_locality_order_equal_numpy(seed, n, e):
    """The half builder against numpy's stable sort, CSR pointers and
    ``_reference_norm``; the locality order against the numpy twin (also
    with most vertices isolated)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(n, size=e).astype(np.int32)
    dst = rng.integers(n, size=e).astype(np.int32)
    perm, indptr, norm = native.build_half_native(src, dst, n)
    np.testing.assert_array_equal(perm, np.argsort(dst, kind="stable"))
    np.testing.assert_array_equal(indptr, np.concatenate(
        [[0], np.cumsum(np.bincount(dst, minlength=n))]))
    np.testing.assert_allclose(norm, pgraph._reference_norm(src, dst, n),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(native.locality_order_native(src, dst, n),
                                  _locality_order_numpy(src, dst, n))


@pytest.mark.parametrize("corpus", ["toy", "synth"])
def test_build_graph_engines_equal_jax(corpus):
    """Every field of both halves (and the stacked view) of the C++ engine's
    graph equals the numpy engine's and the JAX package's numpy graph, bit
    for bit (both engines take the norm from numpy's degree count)."""
    from kgc_gcn_torch.data.toy import toy_triples
    if corpus == "toy":
        train, valid, test = toy_triples(n_ent=12, n_rel=4, n_train=40)
    else:
        train, valid, test = toy_triples(n_ent=300, n_rel=9, n_train=3000)
    ds = pdata.build_dataset(corpus, train, valid, test)
    args = (ds.train_triples, ds.num_entity, ds.num_relation,
            pgraph.EDGE_PAD)
    nat = pgraph.build_graph(*args)
    num = pgraph.build_graph(*args, use_native=False)
    jx = jgraph.build_graph(*args, use_native=False)
    for name in ("inb", "outb"):
        for f in dataclasses.fields(pgraph.GraphHalf):
            a = getattr(getattr(nat, name), f.name)
            if not isinstance(a, torch.Tensor):
                assert a == getattr(getattr(num, name), f.name)
                continue
            for b in (getattr(getattr(num, name), f.name).numpy(),
                      np.asarray(getattr(getattr(jx, name), f.name))):
                np.testing.assert_array_equal(a.numpy(), b, err_msg=f.name)
    for f in dataclasses.fields(pgraph.GraphStacked):
        np.testing.assert_array_equal(
            getattr(nat.stacked, f.name).numpy(),
            np.asarray(getattr(jx.stacked, f.name)), err_msg=f.name)


def test_out_of_range_edges_raise_before_the_library():
    src, dst = np.array([0, 1], np.int32), np.array([1, 5], np.int32)
    for fn in (native.build_half_native, native.locality_order_native):
        with pytest.raises(ValueError, match="lie in"):
            fn(src, dst, 5)
        with pytest.raises(ValueError, match="one"):
            fn(src, dst[:1], 5)


def test_malformed_line_raises(tmp_path):
    root = tmp_path / "Bad"
    root.mkdir()
    (root / "train.txt").write_text("a\tr\tb\nc\td\n")
    for s in ("valid", "test"):
        (root / f"{s}.txt").write_text("a\tr\tb\n")
    with pytest.raises(ValueError, match="malformed line 2"):
        pdata.load_dataset("Bad", str(tmp_path))
    with pytest.raises(ValueError, match="malformed line"):
        pdata.load_dataset("Bad", str(tmp_path), use_native=False)


def test_use_native_false_reaches_numpy(tmp_path, monkeypatch):
    """With ``use_native=False`` no call reaches the library."""
    write_toy(str(tmp_path), n_ent=15, n_rel=5, n_train=60)

    def refuse():
        raise AssertionError("the numpy engine called the C++ library")

    monkeypatch.setattr(native, "get_lib", refuse)
    ds = pdata.load_dataset("Toy", str(tmp_path), use_native=False)
    pgraph.build_graph(ds.train_triples, ds.num_entity, ds.num_relation,
                       use_native=False)
    with pytest.raises(AssertionError, match="numpy engine"):
        pdata.load_dataset("Toy", str(tmp_path))


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """The port does not fall back: a source that does not compile raises
    with g++'s message, and so does the default engine."""
    bad = tmp_path / "graphcore.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*\n.*error"):
        native.build()
    write_toy(str(tmp_path), n_ent=15, n_rel=5, n_train=60)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pdata.load_dataset("Toy", str(tmp_path))
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_concurrent_builds_land_one_whole_library(tmp_path, monkeypatch):
    """Builders racing on one source (test workers, ranks) each write a
    file of their own and rename it into place: every one gets the same
    loadable library, keyed by the source, and no temporary file stays."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build())
        except Exception as e:   # reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(set(paths)) == 1 and paths[0].parent == tmp_path
    assert paths[0] == native.library_path()
    assert paths[0].name.startswith("libgraphcore-")
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]
    lib = native._bind(__import__("ctypes").CDLL(str(paths[0])))
    order = np.empty(3, np.int32)
    lib.gc_locality_order(np.array([0, 1], np.int32),
                          np.array([1, 2], np.int32), 2, 3, order)
    assert sorted(order) == [0, 1, 2]
