"""Locality-aware entity numbering, ``--partition locality`` (the port's
``kgc_gcn_tpu/data/partition.py``).

Corpora number entities in first-seen file order (reference
data_loader.py:64-74), which is close to random with respect to the graph.
``locality`` renumbers them by deterministic label-propagation communities of
the undirected train graph, so community members get contiguous ids.  The
edge partition of ``parallel/mesh.py`` cuts each dst-sorted half into
contiguous slices, so with communities numbered contiguously a slice covers
fewer destination rows and fewer of its edges' rows straddle two shards.

The relabelling is an isomorphism: entity names keep their meaning
(``entity2id`` is rebuilt through the permutation), every split's triples
are remapped, and the dataset is rebuilt through the standard pipeline.  A
checkpoint trained under a partition is restored under the same one; the
CLI records the flag in ``params.json`` and adopts it on restore.

The order comes from the C++ engine (``utils/native.py``) or, with
``use_native=False``, from its numpy twin, a Python loop over vertices that
is only fit for small graphs; both give the same order.
"""

from __future__ import annotations

import numpy as np

from kgc_gcn_torch.data.dataset import KGDataset, build_dataset_from_ids

PARTITIONS = ("contiguous", "locality")


def _locality_order_numpy(src: np.ndarray, dst: np.ndarray,
                          n_ent: int) -> np.ndarray:
    """Asynchronous label propagation in id order (each vertex takes its
    neighbours' most frequent label, ties to the smallest; at most 10
    sweeps), then communities in (size desc, label asc) order, vertices by
    id: ``gc_locality_order``'s twin."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    deg = np.bincount(src, minlength=n_ent) + np.bincount(dst, minlength=n_ent)
    indptr = np.zeros(n_ent + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    ends = np.concatenate([src, dst])
    peers = np.concatenate([dst, src])
    adj = peers[np.argsort(ends, kind="stable")]

    label = np.arange(n_ent, dtype=np.int64)
    for _ in range(10):
        changed = False
        for v in range(n_ent):
            nb = adj[indptr[v]: indptr[v + 1]]
            if not len(nb):
                continue
            vals, cnts = np.unique(label[nb], return_counts=True)
            best = vals[np.argmax(cnts)]   # vals sorted: first max = smallest
            if best != label[v]:
                label[v] = best
                changed = True
        if not changed:
            break
    csize = np.bincount(label, minlength=n_ent)
    order = np.lexsort((np.arange(n_ent), label, -csize[label]))
    return order.astype(np.int32)


def locality_order(train_triples: np.ndarray, n_ent: int,
                   use_native: bool = True) -> np.ndarray:
    """(n_ent,) int32 community order: ``order[k]`` is the old id of new id
    ``k``."""
    tri = np.asarray(train_triples)
    src, dst = tri[:, 0].astype(np.int32), tri[:, 2].astype(np.int32)
    if use_native:
        from kgc_gcn_torch.utils.native import locality_order_native
        return locality_order_native(src, dst, n_ent)
    return _locality_order_numpy(src, dst, n_ent)


def apply_partition(ds: KGDataset, order: np.ndarray,
                    use_native: bool = True) -> KGDataset:
    """The dataset rebuilt with entities renumbered by ``order``."""
    n = ds.num_entity
    if len(order) != n:
        raise ValueError(f"order has {len(order)} ids for {n} entities")
    new_of_old = np.empty(n, np.int64)
    new_of_old[np.asarray(order, np.int64)] = np.arange(n, dtype=np.int64)

    def remap(tri: np.ndarray) -> np.ndarray:
        tri = np.asarray(tri, np.int64).copy()
        if len(tri):
            tri[:, 0] = new_of_old[tri[:, 0]]
            tri[:, 2] = new_of_old[tri[:, 2]]
        return tri

    ids = {"train": remap(ds.train_triples),
           "valid": remap(ds.valid_triples),
           "test": remap(ds.test_triples)}
    entity2id = {name: int(new_of_old[i]) for name, i in ds.entity2id.items()}
    return build_dataset_from_ids(ds.name, entity2id, dict(ds.relation2id),
                                  ids, use_native=use_native)


def partition_dataset(ds: KGDataset, partition: str,
                      use_native: bool = True) -> KGDataset:
    """The dataset under the ``--partition`` numbering: ``contiguous`` keeps
    the file's first-seen order, ``locality`` renumbers."""
    if partition not in PARTITIONS:
        raise ValueError(f"unknown partition {partition!r}; "
                         f"valid: {PARTITIONS}")
    if partition == "contiguous" or ds.num_entity == 0:
        return ds
    return apply_partition(
        ds, locality_order(ds.train_triples, ds.num_entity, use_native),
        use_native)
