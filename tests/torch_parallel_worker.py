"""One rank of the port's multi-process tests (tests/test_torch_parallel.py).

    WORLD_SIZE=2 RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_parallel_worker.py spec.json out_dir

joins a gloo group on the CPU, lays the ranks out as the spec's
``[data, graph]`` mesh, runs each of the spec's cases on the toy problem and
writes ``out_dir/rank<r>.npz``.  The test process imports the same
functions and runs every case with ``mesh=None``: the single-process
reference.  This module imports the port only (no JAX), so that a rank
starts in the time of a torch import.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from kgc_gcn_torch.config import Config  # noqa: E402
from kgc_gcn_torch.data.batching import make_banks  # noqa: E402
from kgc_gcn_torch.data.dataset import build_dataset  # noqa: E402
from kgc_gcn_torch.data.graph import build_graph  # noqa: E402
from kgc_gcn_torch.data.toy import toy_triples  # noqa: E402
from kgc_gcn_torch.models import build_model  # noqa: E402
from kgc_gcn_torch.convert import model_leaf_names  # noqa: E402
from kgc_gcn_torch.ops.scatter import aggregate_half  # noqa: E402
from kgc_gcn_torch.parallel import distributed  # noqa: E402
from kgc_gcn_torch.parallel.edge_parallel import (  # noqa: E402
    make_pallas_sharded_aggregate, make_sharded_aggregate)
from kgc_gcn_torch.parallel.mesh import (  # noqa: E402
    edge_table_names, make_mesh, shard_batches, shard_graph)
from kgc_gcn_torch.train import optim  # noqa: E402
from kgc_gcn_torch.train.checkpoint import save_checkpoint  # noqa: E402
from kgc_gcn_torch.train.loop import Trainer  # noqa: E402
from kgc_gcn_torch.train.negative import NegativeSamplingTrainer  # noqa: E402


def problem():
    """The toy corpus of tests/conftest.py's ``toy`` fixture, on the CPU
    (edges padded to 8: 40 a half, which 2 and 4 shards divide)."""
    train, valid, test = toy_triples(n_ent=12, n_rel=4, n_train=40)
    ds = build_dataset("toy", train, valid, test)
    graph = build_graph(ds.train_triples, ds.num_entity, ds.num_relation,
                        pad_to=8)
    return ds, graph, make_banks(ds)


def _whole(t: torch.Tensor, name: str, model, mesh) -> np.ndarray:
    """A leaf as one array: a per-edge table's slices gathered."""
    if mesh is not None and name in edge_table_names(model):
        t = distributed.all_gather_cat(t.detach(), mesh.graph_group, 1)
    return t.detach().float().numpy().copy()


def run_agg(case: dict, mesh, graph) -> dict:
    """The sharded MGCN aggregate of both halves: outputs and the
    gradients of ``Σ out · cot`` in x, rel_all and the per-edge table."""
    rng = np.random.default_rng(case["seed"])
    d, n = case["d"], graph.n_ent
    f32 = lambda *shape: torch.tensor(rng.normal(0, 1, shape),
                                      dtype=torch.float32)
    x, rel_all = f32(n, d), f32(2 * graph.n_rel + 1, d)
    etab, cot = f32(2, graph.e_pad, d), f32(2, n, d)
    out = {}
    for tag in ("kernel", "plain"):
        xs, rs, et = (t.clone().requires_grad_() for t in (x, rel_all, etab))
        if mesh is None:
            halves = (graph.inb, graph.outb)
            res = [aggregate_half(xs, rs, et[i], h, n) for i, h in
                   enumerate(halves)]
            et_local = et
        else:
            local = shard_graph(graph, mesh)
            halves = (local.inb, local.outb)
            lo = mesh.graph_rank * (graph.e_pad // mesh.graph)
            et_local = et[:, lo: lo + graph.e_pad // mesh.graph]
            make = (make_pallas_sharded_aggregate(mesh.graph_group, n)
                    if tag == "kernel" else
                    make_sharded_aggregate(mesh.graph_group, n))
            res = make(xs, rs, (et_local[0], et_local[1]), halves)
        loss = sum((r * c).sum() for r, c in zip(res, cot))
        gx, gr, ge = torch.autograd.grad(loss, (xs, rs, et))
        if mesh is not None:
            ge = distributed.all_gather_cat(
                ge[:, lo: lo + graph.e_pad // mesh.graph], mesh.graph_group,
                1)
        for k, v in (("in", res[0]), ("out", res[1]), ("dx", gx),
                     ("drel", gr), ("detab", ge)):
            out[f"{tag}.{k}"] = v.detach().numpy().copy()
    return out


def _model(case: dict, ds, graph, mesh):
    cfg = Config(**case["cfg"])
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=graph.e_pad, mesh=mesh)
    state = np.load(case["state"])
    model.load_state_dict({k: torch.from_numpy(state[k]) for k in state.files})
    return cfg, model


def _batch(case: dict, mesh):
    """(idx, mask, negatives or None) of this rank's rows, and the loss
    scale (its rows over the global batch's)."""
    idx = np.asarray(case["idx"], np.int64)[None]
    mask = np.asarray(case["mask"], np.float32)[None]
    rows = max(mask.sum(), 1.0)
    neg = (np.asarray(case["neg"], np.int64)[None]
           if "neg" in case else np.zeros_like(idx)[..., None])
    cols = shard_batches(mesh, np.arange(idx.shape[1])[None], mask)[0][0]
    idx, mask, neg = idx[:, cols], mask[:, cols], neg[:, cols]
    return (torch.from_numpy(idx[0]), torch.from_numpy(mask[0]),
            torch.from_numpy(neg[0]) if "neg" in case else None,
            float(max(mask.sum(), 1.0) / rows))


def _trainer(cfg, model, graph, banks, mesh):
    cls = (NegativeSamplingTrainer if cfg.train_mode == "negative_sampling"
           else Trainer)
    return cls(cfg, model, graph, banks, mesh=mesh)


def _step_batch(trainer, idx, mask, neg):
    """The loss arguments; the negatives given, not drawn."""
    if neg is None:
        return trainer.batch(idx, mask)
    return trainer.pos_triples[idx], mask, neg


def run_step(case: dict, mesh, ds, graph, banks) -> dict:
    """One step from the case's weights: the loss (summed over the data
    group), every gradient, the BN statistics after the forward, and, from
    a second copy of the weights, every leaf after one ``train_step``; with
    ``ckpt``, that model's checkpoint is written."""
    out = {}
    idx, mask, neg, scale = _batch(case, mesh)
    cfg, model = _model(case, ds, graph, mesh)
    trainer = _trainer(cfg, model, graph, banks, mesh)
    loss, grads = trainer.gradients(*_step_batch(trainer, idx, mask, neg),
                                    scale=scale)
    if mesh is not None:
        loss = distributed.flat_all_reduce([loss], mesh.data_group)[0]
    out["loss"] = np.asarray(float(loss))
    names = model_leaf_names(model, cfg)[0]
    # the clip's global norm counts the whole per-edge table
    clipped = optim.clip_by_global_norm(
        grads, case["clip"], trainer.sharded,
        mesh.graph_group if mesh is not None else None)
    for name, g, c in zip(names, grads, clipped):
        out[f"grad.{name}"] = _whole(g, name, model, mesh)
        out[f"clipped.{name}"] = _whole(c, name, model, mesh)
    for name, buf in model.named_buffers():
        out[f"buffer.{name}"] = buf.numpy().copy()

    cfg, model = _model(case, ds, graph, mesh)
    trainer = _trainer(cfg, model, graph, banks, mesh)
    trainer.train_step(case["lr"], *_step_batch(trainer, idx, mask, neg),
                       scale=scale)
    for name, p in zip(names, trainer.params):
        out[f"param.{name}"] = _whole(p, name, model, mesh)
    if case.get("ckpt"):
        save_checkpoint(case["ckpt"], model, trainer.opt_state, cfg, 0.25)
    return out


def run_case(case: dict, mesh, ds, graph, banks) -> dict:
    if case["kind"] == "agg":
        return run_agg(case, mesh, graph)
    return run_step(case, mesh, ds, graph, banks)


def main(spec_path: str, out_dir: str) -> None:
    torch.manual_seed(0)
    spec = json.loads(Path(spec_path).read_text())
    distributed.maybe_initialize("cpu")
    data, graph_axis = spec["mesh"]
    mesh = make_mesh(data, graph_axis, torch.device("cpu"))
    ds, graph, banks = problem()
    results = {}
    for case in spec["cases"]:
        for k, v in run_case(case, mesh, ds, graph, banks).items():
            results[f"{case['name']}/{k}"] = v
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **results)
    distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
