"""Knowledge-graph corpus: vocab, triples and query materialization.

The port's copy of ``kgc_gcn_tpu/data/dataset.py`` with both of its
engines: the C++ parser and sr2o grouper of ``native/graphcore.cpp``
(``utils/native.py``; ``use_native=True``, the default) and the numpy ones
(``use_native=False``), which give the same fields.

Reference behavior replicated (reference data_loader.py:54-120):
  * entity/relation vocab over ALL splits in first-seen order, lowercased
    (data_loader.py:64-74), lowercased at triple lookup too;
  * reverse relations get ids ``R..2R-1`` (data_loader.py:73-74);
  * ``sr2o`` maps: a train-only snapshot (training labels) and an all-splits
    map (filtered-eval labels) (data_loader.py:80-94);
  * train queries are DEDUPLICATED (s, r) pairs including reverse queries
    (data_loader.py:100-102);
  * valid/test queries are per-triple: tail query (s, r, o) and head query
    (o, r+R, s), with all-splits filter labels (data_loader.py:104-110).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

SPLITS = ("train", "valid", "test")


class LabelSet(Sequence):
    """CSR-stored list-of-label-lists: ``values`` (int32) + ``offsets``
    (int64, Q+1).  Behaves like the ``List[List[int]]`` it stands for while
    letting the padded label-matrix build stay vectorized."""

    __slots__ = ("values", "offsets")

    def __init__(self, values: np.ndarray, offsets: np.ndarray):
        self.values = np.asarray(values, np.int32)
        self.offsets = np.asarray(offsets, np.int64)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError("LabelSet index out of range")
        return self.values[self.offsets[i]:self.offsets[i + 1]].tolist()

    def __eq__(self, other):
        if isinstance(other, LabelSet):
            return (self.offsets.shape == other.offsets.shape
                    and bool(np.array_equal(self.offsets, other.offsets))
                    and bool(np.array_equal(self.values, other.values)))
        if isinstance(other, (list, tuple)):
            return list(self) == list(other)
        return NotImplemented

    def __repr__(self):
        return f"LabelSet({len(self)} rows, {len(self.values)} labels)"


@dataclass
class EvalQueries:
    """Per-triple eval queries for one split+direction."""

    triples: np.ndarray            # int32 (Q, 3) — (src, rel, obj)
    labels: Sequence[List[int]]    # filter label sets (all-splits sr2o)


@dataclass
class KGDataset:
    name: str
    entity2id: Dict[str, int]
    relation2id: Dict[str, int]          # includes '<rel>_reverse' ids R..2R-1
    num_entity: int
    num_relation: int                    # R (forward only); model uses 2R
    num_edge: int                        # E = number of train triples
    train_triples: np.ndarray            # int64 (E, 3)
    valid_triples: np.ndarray
    test_triples: np.ndarray
    train_queries: np.ndarray            # int32 (Q, 2) — unique (s, r) incl. reverse
    train_labels: Sequence[List[int]]    # true objects per train query
    eval_queries: Dict[str, EvalQueries] = field(default_factory=dict)
    # keys: valid_tail, valid_head, test_tail, test_head

    @property
    def num_train_queries(self) -> int:
        return len(self.train_queries)


def _read_triples(path: str) -> List[Tuple[str, str, str]]:
    out = []
    with open(path, "r") as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            if len(parts) != 3:
                raise ValueError(f"{path}: malformed line {line!r}")
            out.append((parts[0].lower(), parts[1].lower(), parts[2].lower()))
    return out


def load_dataset(name: str, data_dir: str = "data",
                 use_native: bool = True) -> KGDataset:
    """Load ``<data_dir>/<name>/{train,valid,test}.txt`` TSV triple files,
    parsed by the C++ engine (``use_native``) or in Python; both give the
    same vocabularies (first-seen, lowercased) and triples."""
    root = os.path.join(data_dir, name)
    paths = {s: os.path.join(root, s + ".txt") for s in SPLITS}
    if use_native:
        from kgc_gcn_torch.utils.native import load_corpus_native
        entity2id, rel_fwd, ids = load_corpus_native(
            paths["train"], paths["valid"], paths["test"])
        relation2id = dict(rel_fwd)
        relation2id.update({r + "_reverse": i + len(rel_fwd)
                            for r, i in rel_fwd.items()})
        return build_dataset_from_ids(name, entity2id, relation2id, ids)
    raw = {s: _read_triples(paths[s]) for s in SPLITS}
    return build_dataset(name, raw["train"], raw["valid"], raw["test"],
                         use_native=False)


def build_dataset(
    name: str,
    train: Sequence[Tuple[str, str, str]],
    valid: Sequence[Tuple[str, str, str]],
    test: Sequence[Tuple[str, str, str]],
    use_native: bool = True,
) -> KGDataset:
    raw = {"train": list(train), "valid": list(valid), "test": list(test)}

    # vocab in first-seen order over all splits (reference data_loader.py:64-74)
    entity2id: Dict[str, int] = {}
    relation2id: Dict[str, int] = {}
    for split in SPLITS:
        for s, r, o in raw[split]:
            if s not in entity2id:
                entity2id[s] = len(entity2id)
            if r not in relation2id:
                relation2id[r] = len(relation2id)
            if o not in entity2id:
                entity2id[o] = len(entity2id)
    num_relation = len(relation2id)
    for r in list(relation2id.keys()):
        relation2id[r + "_reverse"] = relation2id[r] + num_relation

    ids = {}
    for split in SPLITS:
        tri = np.empty((len(raw[split]), 3), dtype=np.int64)
        for i, (s, r, o) in enumerate(raw[split]):
            tri[i] = (entity2id[s], relation2id[r], entity2id[o])
        ids[split] = tri
    return build_dataset_from_ids(name, entity2id, relation2id, ids,
                                  use_native=use_native)


def _group_first_seen(key: np.ndarray, vals: np.ndarray, n_vals: int):
    """Vectorized transcription of the reference's dict-of-dicts build
    (``sr2o.setdefault(key, {})[val] = None`` over a stream): returns
    (keys in FIRST-SEEN order (G,), grouped values (first-seen-deduped,
    first-seen order within each group), offsets (G+1,), sorted-key lookup
    (uniq_sorted, rank)) — ``rank[searchsorted(uniq_sorted, k)]`` maps a key
    to its group index."""
    kv = key * np.int64(n_vals) + vals               # composite (key, val) id
    _, first_pos = np.unique(kv, return_index=True)  # first occurrence of each pair
    kept = np.sort(first_pos)                        # stream order, deduped
    k_kept, v_kept = key[kept], vals[kept]
    uniq_k, kfirst = np.unique(k_kept, return_index=True)
    order = np.argsort(kfirst, kind="stable")        # sorted-unique → first-seen
    rank = np.empty(len(uniq_k), np.int64)
    rank[order] = np.arange(len(uniq_k))
    key_rank = rank[np.searchsorted(uniq_k, k_kept)]
    perm = np.argsort(key_rank, kind="stable")       # group, keep stream order
    counts = np.bincount(key_rank, minlength=len(uniq_k))
    offsets = np.zeros(len(uniq_k) + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return uniq_k[order], v_kept[perm], offsets, (uniq_k, rank)


def _gather_label_rows(keys: np.ndarray, lookup, values: np.ndarray,
                       offsets: np.ndarray) -> LabelSet:
    """Per-row label lists for the given (present) keys, as a LabelSet."""
    uniq_k, rank = lookup
    g = rank[np.searchsorted(uniq_k, keys)]
    starts, lens = offsets[g], offsets[g + 1] - offsets[g]
    out_off = np.zeros(len(g) + 1, np.int64)
    np.cumsum(lens, out=out_off[1:])
    idx = (np.arange(int(out_off[-1]), dtype=np.int64)
           - np.repeat(out_off[:-1], lens) + np.repeat(starts, lens))
    return LabelSet(values[idx], out_off)


def _sr_stream(ids: Dict[str, np.ndarray], splits, num_relation: int):
    """The (key, val) stream the reference's sr2o loop walks: per split, per
    triple, the tail entry (s, r)→o then the head entry (o, r+R)→s."""
    ks, vs = [], []
    for split in splits:
        tri = np.asarray(ids[split], np.int64)
        n = len(tri)
        s2 = np.empty(2 * n, np.int64)
        r2 = np.empty(2 * n, np.int64)
        v2 = np.empty(2 * n, np.int64)
        s2[0::2], r2[0::2], v2[0::2] = tri[:, 0], tri[:, 1], tri[:, 2]
        s2[1::2], r2[1::2], v2[1::2] = (tri[:, 2], tri[:, 1] + num_relation,
                                        tri[:, 0])
        ks.append(s2 * np.int64(2 * num_relation) + r2)
        vs.append(v2)
    return np.concatenate(ks), np.concatenate(vs)


def _eval_query_arrays(tri: np.ndarray, num_relation: int):
    """Per-triple eval queries (reference data_loader.py:104-110): the tail
    query (s, r, o) and the head query (o, r+R, s), int32."""
    tri = np.asarray(tri, np.int64)
    tail = np.stack([tri[:, 0], tri[:, 1], tri[:, 2]], axis=1).astype(np.int32)
    head = np.stack([tri[:, 2], tri[:, 1] + num_relation,
                     tri[:, 0]], axis=1).astype(np.int32)
    return tail, head


def build_dataset_from_ids(
    name: str,
    entity2id: Dict[str, int],
    relation2id: Dict[str, int],     # incl. '<rel>_reverse' ids R..2R-1
    ids: Dict[str, np.ndarray],      # {split: (n, 3) int64 id triples}
    use_native: bool = True,         # False: the numpy/dict engines only
) -> KGDataset:
    num_entity = len(entity2id)
    num_relation = len(relation2id) // 2

    # the C++ grouper (one hash pass) takes any vocabulary; the numpy
    # composite-id group-by needs n_ent²·2R to fit int64, and beyond that the
    # reference-literal dict path below runs instead
    fits = (num_entity and num_relation
            and float(num_entity) * num_entity * 2 * num_relation < 2.0**62)
    grouped = None
    if use_native and num_relation:
        from kgc_gcn_torch.utils.native import group_sr2o_splits_native
        (keys_t, vals_t, off_t), (keys_a, vals_a, off_a) = \
            group_sr2o_splits_native(
                np.concatenate([np.asarray(ids[s], np.int64).reshape(-1, 3)
                                for s in SPLITS]),
                len(ids["train"]), num_relation)
        order_a = np.argsort(keys_a)
        # keys_a[order_a] is sorted; its first-seen rank IS order_a
        grouped = (keys_t, vals_t, off_t, vals_a, off_a,
                   (keys_a[order_a], order_a))
    elif fits:
        tk, tv = _sr_stream(ids, ("train",), num_relation)
        ak, av = _sr_stream(ids, SPLITS, num_relation)
        keys_t, vals_t, off_t, _ = _group_first_seen(tk, tv, num_entity)
        _, vals_a, off_a, lookup = _group_first_seen(ak, av, num_entity)
        grouped = (keys_t, vals_t, off_t, vals_a, off_a, lookup)
    if grouped is not None:
        two_r = 2 * num_relation
        keys_t, vals_t, off_t, vals_a, off_a, lookup = grouped
        # train-only snapshot → train queries/labels (data_loader.py:100-102)
        tq = np.stack([keys_t // two_r, keys_t % two_r],
                      axis=1).astype(np.int32).reshape(-1, 2)
        tl: Sequence[List[int]] = LabelSet(vals_t, off_t)
        # all-splits map → filtered-eval labels (data_loader.py:104-110)
        eval_queries = {}
        for split in ("valid", "test"):
            tail, head = _eval_query_arrays(ids[split], num_relation)
            for tag, q in (("tail", tail), ("head", head)):
                k = q[:, 0].astype(np.int64) * two_r + q[:, 1]
                eval_queries[f"{split}_{tag}"] = EvalQueries(
                    q, _gather_label_rows(k, lookup, vals_a, off_a))
        return _finish_dataset(name, entity2id, relation2id, ids,
                               num_entity, num_relation, tq, tl, eval_queries)

    # ---- reference-literal dict path (huge-vocab fallback) ----
    sr2o: Dict[Tuple[int, int], dict] = {}
    sr2o_train: Dict[Tuple[int, int], List[int]] = {}
    for split in SPLITS:
        for sub, rel, obj in ids[split].tolist():
            sr2o.setdefault((sub, rel), {})[obj] = None
            sr2o.setdefault((obj, rel + num_relation), {})[sub] = None
        if split == "train":
            sr2o_train = {k: list(v) for k, v in sr2o.items()}
    sr2o_all = {k: list(v) for k, v in sr2o.items()}

    tq = np.array(list(sr2o_train.keys()), dtype=np.int32).reshape(-1, 2)
    tl = [sr2o_train[(int(s), int(r))] for s, r in tq]
    eval_queries = {}
    for split in ("valid", "test"):
        tail, head = _eval_query_arrays(ids[split], num_relation)
        eval_queries[f"{split}_tail"] = EvalQueries(
            tail, [sr2o_all[(int(s), int(r))] for s, r, _ in tail])
        eval_queries[f"{split}_head"] = EvalQueries(
            head, [sr2o_all[(int(s), int(r))] for s, r, _ in head])
    return _finish_dataset(name, entity2id, relation2id, ids,
                           num_entity, num_relation, tq, tl, eval_queries)


def _finish_dataset(name, entity2id, relation2id, ids, num_entity,
                    num_relation, tq, tl, eval_queries) -> KGDataset:
    ds = KGDataset(
        name=name,
        entity2id=entity2id,
        relation2id=relation2id,
        num_entity=num_entity,
        num_relation=num_relation,
        num_edge=len(ids["train"]),
        train_triples=ids["train"],
        valid_triples=ids["valid"],
        test_triples=ids["test"],
        train_queries=tq,
        train_labels=tl,
        eval_queries=eval_queries,
    )
    logging.info(
        "entity=%d, relation=%d, train_triplets=%d, valid_triplets=%d, test_triplets=%d",
        ds.num_entity, ds.num_relation, len(ds.train_triples),
        len(ds.valid_triples), len(ds.test_triples))
    return ds
