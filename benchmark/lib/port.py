"""How the benchmark drives the port (``kgc_gcn_torch``): its data layer on
the generated triples, its model with the benchmark's weights, and the
launch counters of its kernel wrappers.  Only the drivers import this."""

from __future__ import annotations

import os
import time
from typing import Dict, Tuple

import numpy as np
import torch

# opt-in bf16 streams of the port; the configurations state float32
OPT_IN_ENV = ("KGC_MGCN_CONTRIB", "KGC_EDGE_CONTRIB", "KGC_BASIS_READBACK")


def prepare_env() -> None:
    """Before the port is imported: its opt-in streams off.  (The port's
    kernels build into ``build/kgc_gcn_torch/`` inside the checkout, a
    fixed path.)"""
    for name in OPT_IN_ENV:
        os.environ.pop(name, None)


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if on_card(device):
        torch.cuda.synchronize()


def card_name(device) -> str:
    return torch.cuda.get_device_name() if on_card(device) else "cpu"


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated() if on_card(device) else 0


def config(cell, seed: int):
    from kgc_gcn_torch.config import Config
    return Config(**cell.config["port"], seed=seed)


def data(kg, device, bank_keys) -> Tuple[object, object, dict, float]:
    """(dataset, graph, banks, seconds): the port's data layer on the
    generated id triples, its graph and the named query banks moved to
    ``device``, timed by the host clock through to the card."""
    from kgc_gcn_torch.data.batching import make_query_bank
    from kgc_gcn_torch.data.dataset import build_dataset_from_ids
    from kgc_gcn_torch.data.graph import build_graph
    entity2id = {f"e{i}": i for i in range(kg.n_ent)}
    relation2id = {f"r{i}": i for i in range(kg.n_rel)}
    relation2id.update({f"r{i}_reverse": i + kg.n_rel for i in range(kg.n_rel)})
    t0 = time.perf_counter()
    ds = build_dataset_from_ids("bench", entity2id, relation2id, kg.triples)
    graph = build_graph(ds.train_triples, ds.num_entity, ds.num_relation)
    banks = {}
    for key in bank_keys:
        if key == "train":
            banks[key] = make_query_bank(ds.train_queries, ds.train_labels,
                                         ds.num_entity)
        else:
            eq = ds.eval_queries[key]
            banks[key] = make_query_bank(eq.triples, eq.labels, ds.num_entity)
    graph = graph.to(device)
    banks = {k: b.to(device) for k, b in banks.items()}
    sync(device)
    return ds, graph, banks, time.perf_counter() - t0


def dims(kg, graph) -> dict:
    """The shapes the work counters take."""
    tri = kg.triples["train"]
    pad = graph.e_pad > graph.n_edge
    rows = [len(np.union1d(np.unique(tri[:, c]), [kg.n_ent - 1] if pad else []))
            for c in (2, 0)]
    return {"n_ent": kg.n_ent, "n_rel": kg.n_rel, "n_edge": kg.n_train,
            "e_pad": graph.e_pad, "rows_with_edges": rows,
            "eval_queries": 2 * len(kg.triples["test"])}


def place_edge_table(table: torch.Tensor, graph) -> torch.Tensor:
    """A (2E, d) per-edge table in triple order (row i the triple i, E + i
    its reverse) in the port's positional (2, E_pad, d) layout: each
    half's real positions take the rows of their edge ids, padding rows
    zeros."""
    out = torch.zeros(2, graph.e_pad, table.shape[1], device=table.device)
    for h, half in enumerate((graph.inb, graph.outb)):
        e = half.e_real
        out[h, :e] = table[half.eid[:e].long()]
    return out


def model(cfg, kg, graph, weights: Dict[str, torch.Tensor], edge_tables,
          device):
    """The port's model for ``cfg``, its state replaced by ``weights``.
    It is built on ``device`` (its own initial draw there, from a generator
    on the device), then every tensor of its state takes the benchmark's."""
    from kgc_gcn_torch.models import build_model
    gen = torch.Generator(device=device).manual_seed(cfg.seed % 2**32)
    with torch.device(device):
        m = build_model(cfg, kg.n_ent, kg.n_rel, kg.n_train,
                        e_pad=graph.e_pad, generator=gen)
    state = m.state_dict()
    if set(state) != set(weights):
        raise KeyError(f"the reference's leaves {sorted(weights)} are not "
                       f"the model's {sorted(state)}")
    with torch.no_grad():
        for name, value in weights.items():
            if name in edge_tables:
                value = place_edge_table(value, graph)
            state[name].copy_(value)
    return m


def counters() -> Dict[str, int]:
    """The launch counters of the port's kernel wrappers, by the field of
    ``ops.kernels.Kernels`` that holds each."""
    import dataclasses
    from kgc_gcn_torch.ops.kernels import KERNELS
    return {f.name: getattr(KERNELS, f.name).launches
            for f in dataclasses.fields(KERNELS)}


def counter_deltas(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in counters().items()}
