"""``--partition`` in the port (kgc_gcn_torch/data/partition.py, the CLI's
flag): the order and the relabelled dataset equal the JAX package's field
by field, with either engine; the relabelling is an isomorphism (names keep
their triples and filter sets, and a model with its entity rows permuted
ranks every eval query the same); the CLI records the flag and adopts it on
restore."""

import json

import numpy as np
import pytest
import torch

from kgc_gcn_tpu.data import partition as jpart
from kgc_gcn_tpu.data.dataset import build_dataset as jax_build_dataset

from kgc_gcn_torch import cli
from kgc_gcn_torch.data import partition as ppart
from kgc_gcn_torch.data.batching import make_banks
from kgc_gcn_torch.data.dataset import build_dataset
from kgc_gcn_torch.data.graph import build_graph
from kgc_gcn_torch.data.toy import toy_triples, write_toy
from kgc_gcn_torch.models import build_model
from kgc_gcn_torch.train.loop import evaluate
from test_torch_common import port_cfg
from test_torch_native import _assert_datasets_equal


def _clustered(seed=0, n_comm=4, size=15, n_rel=3, n_edge=240):
    """Name triples of communities whose members are numbered in first-seen
    order across communities (interleaved), 90 % of edges inside one."""
    rng = np.random.default_rng(seed)

    def split(n):
        out = []
        for _ in range(n):
            c = rng.integers(n_comm)
            s = c + n_comm * rng.integers(size)
            o = (c if rng.random() < 0.9 else rng.integers(n_comm)) \
                + n_comm * rng.integers(size)
            out.append((f"e{s}", f"r{rng.integers(n_rel)}", f"e{o}"))
        return out
    return split(n_edge), split(30), split(30)


@pytest.mark.parametrize("corpus", ["toy", "clustered"])
@pytest.mark.parametrize("use_native", [True, False])
def test_partition_dataset_equals_jax(corpus, use_native):
    train, valid, test = (toy_triples(n_ent=12, n_rel=4, n_train=40)
                          if corpus == "toy" else _clustered())
    pds = build_dataset(corpus, train, valid, test, use_native=use_native)
    jds = jax_build_dataset(corpus, train, valid, test,
                            use_native=use_native)
    order = ppart.locality_order(pds.train_triples, pds.num_entity,
                                 use_native)
    np.testing.assert_array_equal(order, jpart.locality_order(
        jds.train_triples, jds.num_entity, use_native))
    np.testing.assert_array_equal(order, ppart._locality_order_numpy(
        pds.train_triples[:, 0], pds.train_triples[:, 2], pds.num_entity))
    got = ppart.partition_dataset(pds, "locality", use_native)
    _assert_datasets_equal(got, jpart.partition_dataset(jds, "locality",
                                                        use_native))
    assert ppart.partition_dataset(pds, "contiguous") is pds
    with pytest.raises(ValueError, match="unknown partition"):
        ppart.partition_dataset(pds, "metis")


def test_locality_order_groups_communities():
    """On the clustered corpus, the order puts most of each community's
    members in one contiguous run (the order's purpose)."""
    ds = build_dataset("c", *_clustered())
    order = ppart.locality_order(ds.train_triples, ds.num_entity)
    comm = np.array([int(name[1:]) % 4 for name in ds.entity2id])
    runs = np.count_nonzero(np.diff(comm[order]))
    assert runs < np.count_nonzero(np.diff(comm)) / 3


def test_relabelling_is_an_isomorphism_for_filtered_eval(toy_cfg):
    """Names keep their triples and filter label sets; an R-GCN whose
    entity rows (and decoder bias) follow the order gives the same filtered
    metrics on the relabelled corpus."""
    ds = build_dataset("c", *_clustered())
    new = ppart.partition_dataset(ds, "locality")
    order = ppart.locality_order(ds.train_triples, ds.num_entity)
    assert not np.array_equal(order, np.arange(ds.num_entity))
    name = {i: n for n, i in ds.entity2id.items()}
    new_name = {i: n for n, i in new.entity2id.items()}
    for split in ("train", "valid", "test"):
        a = [(name[s], r, name[o]) for s, r, o in
             getattr(ds, f"{split}_triples").tolist()]
        b = [(new_name[s], r, new_name[o]) for s, r, o in
             getattr(new, f"{split}_triples").tolist()]
        assert a == b
    for key, eq in ds.eval_queries.items():
        assert [sorted(name[v] for v in lab) for lab in eq.labels] == \
            [sorted(new_name[v] for v in lab)
             for lab in new.eval_queries[key].labels]

    cfg = port_cfg(toy_cfg).replace(model="rgcn", decoder="distmult",
                                    num_bases=3, gcn_in_dim=8,
                                    gcn_out_dim=16)
    results = []
    for d, perm in ((ds, None), (new, order)):
        g = build_graph(d.train_triples, d.num_entity, d.num_relation)
        model = build_model(cfg, d.num_entity, d.num_relation, d.num_edge,
                            generator=torch.Generator().manual_seed(5)).eval()
        if perm is not None:
            idx = torch.from_numpy(np.asarray(perm, np.int64))
            with torch.no_grad():
                model.entity_embedding.copy_(model.entity_embedding[idx])
                model.decoder.ent_bias.copy_(model.decoder.ent_bias[idx])
        results.append(evaluate(cfg, model, g, make_banks(d), "valid"))
    for k in results[0]:
        assert results[0][k] == pytest.approx(results[1][k], abs=1e-6), k


def test_cli_records_and_adopts_partition(tmp_path):
    """``--partition locality`` trains, is written to params.json, and a
    restore without the flag takes it from there (the entity numbering of
    the checkpoint)."""
    write_toy(str(tmp_path / "data"))
    base = ["--dataset", "Toy", "--data_dir", str(tmp_path / "data"),
            "--gcn_in_dim", "8", "--gcn_out_dim", "32", "--k_w", "4",
            "--k_h", "8", "--num_filter", "4", "--kernel_size", "3",
            "--device", "cpu"]
    assert cli.main(base + ["--experiments_dir", str(tmp_path / "a"),
                            "--do_train", "--max_epoch", "1",
                            "--partition", "locality"]) == 0
    run = tmp_path / "a" / "Toy"
    assert json.loads((run / "params.json").read_text())["partition"] \
        == "locality"
    args = cli.build_parser().parse_args(
        base + ["--do_test", "--restore_dir", str(run)])
    assert cli.config_from_args(args).partition == "locality"
    assert cli.main(base + ["--experiments_dir", str(tmp_path / "b"),
                            "--do_test", "--restore_dir", str(run)]) == 0
