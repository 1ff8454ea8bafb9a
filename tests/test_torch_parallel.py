"""The port's multi-GPU path on the CPU (kgc_gcn_torch/parallel/*, the
sharded encoders of models/{mgcn,rgcn,rgat}.py, the data-parallel loss,
BatchNorm, clip and evaluation of train/, the checkpoint the ranks write,
the CLI under a launcher): gloo ranks in subprocesses
(tests/torch_parallel_worker.py, which imports no JAX), each world
launched once per module, against the single-process step on the same
weights and batch and, for MGCN and the sharded aggregate, against the
JAX package.

Weights come from the JAX models of tests/test_torch_common.py (seeded);
dropout is off.  Every rank has OMP_NUM_THREADS=1, a free port and a
timeout.  Tolerances: forward values rtol 1e-5; gradients those of
tests/test_torch_train.py (rtol 2e-4, atol 2e-5 of the tensor's largest
gradient, floor 1e-7; the directions that BatchNorm cancels held to noise),
BatchNorm statistics rtol 1e-5; the updated weights atol 1e-3 of the
learning rate, without the directions that BatchNorm cancels (their true
gradient is 0 and Adam scales float noise to steps of size lr) and without
the elements whose gradient is below 1e-4 of its tensor's largest.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kgc_gcn_torch import cli
from kgc_gcn_torch.config import Config, dataset_preset
from kgc_gcn_torch.models import build_model
from kgc_gcn_torch.parallel.edge_parallel import build_local_csr, local_half
from kgc_gcn_torch.parallel.mesh import Mesh
from kgc_gcn_torch.train.checkpoint import load_checkpoint
from kgc_gcn_torch.train.negative import NEG_LOSSES
from test_torch_common import (
    jax_and_port_models, jax_leaves, port_cfg, rgat_cfg, rgcn_cfg)
from torch_parallel_worker import problem, run_case

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_parallel_worker.py"
RANK_TIMEOUT = 150

GRAD_RTOL, GRAD_ATOL, GRAD_FLOOR = 2e-4, 2e-5, 1e-7
BN_TOL = dict(rtol=1e-5, atol=1e-6)
LR = 0.01
UPDATE_ATOL = 1e-3 * LR
DEGENERATE = ("decoder.bn0.bias", "decoder.fc_b")
NOISE = 1e-5
# bn0's scale is degenerate up to BN1's eps: its gradient (~5e-6) cancels
# summands of ~1e-3, so the order of the per-shard sums moves it by ~2e-7
NEAR_DEGENERATE, NEAR_NOISE = ("decoder.bn0.scale",), 1e-6
UPDATE_DEGENERATE = DEGENERATE + NEAR_DEGENERATE
WELL_CONDITIONED = 1e-4
IDX, MASK = [5, 2, 7, 0], [1, 1, 1, 0]
# a data_axis 2 batch of 8 rows, 5 real: the second rank holds 1 real row
IDX8, MASK8 = [5, 2, 7, 0, 9, 3, 1, 4], [1, 1, 1, 1, 1, 0, 0, 0]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(argv, world: int, cwd, env_extra=None):
    """``world`` ranks of ``argv`` on a free port, started."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE=str(world),
                   RANK=str(rank), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), PYTHONPATH=str(ROOT),
                   **(env_extra or {}))
        procs.append(subprocess.Popen(
            ["timeout", "-k", "5", str(RANK_TIMEOUT), sys.executable, *argv],
            cwd=str(cwd), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return procs


def _launch(argv, world: int, cwd, env_extra=None):
    """``world`` ranks of ``argv`` on a free port; each rank's
    (returncode, stdout, stderr), after all have ended or been killed."""
    return _finish(_start(argv, world, cwd, env_extra))


def _finish(procs):
    """Each started rank's (returncode, stdout, stderr), after all have
    ended or been killed; a rank that failed fails the test."""
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT + 30)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (rc, _, err) in enumerate(results):
        assert rc == 0, f"rank {rank} exited {rc}:\n{err[-3000:]}"
    return results


def _world(tmp: Path, mesh, cases):
    """Run the cases on a ``[data, graph]`` mesh; each rank's results."""
    spec = tmp / "spec.json"
    spec.write_text(json.dumps({"mesh": mesh, "cases": cases}))
    _launch([str(WORKER), str(spec), str(tmp)], mesh[0] * mesh[1], ROOT)
    return [dict(np.load(tmp / f"rank{r}.npz"))
            for r in range(mesh[0] * mesh[1])]


def _no_dropout(cfg):
    return cfg.replace(gcn_drop=0.0, conv_drop=0.0, hidden_drop=0.0,
                       feat_drop=0.0)


@pytest.fixture(scope="module")
def weights(toy, toy_cfg, tmp_path_factory):
    """{family: (JAX config, JAX model, params, state, port weights file)}
    for MGCN + ConvE, R-GCN (basis, block) and RGAT + DistMult."""
    tmp = tmp_path_factory.mktemp("weights")
    cfgs = {"mgcn": _no_dropout(toy_cfg),
            "rgcn": rgcn_cfg(toy_cfg), "rgcn_block": rgcn_cfg(
                toy_cfg, num_bases=0, num_blocks=4),
            "rgat": rgat_cfg(toy_cfg)}
    out = {}
    for name, cfg in cfgs.items():
        model, params, state, port = jax_and_port_models(toy, cfg, seed=3)
        path = tmp / f"{name}.npz"
        np.savez(path, **{k: v.numpy() for k, v in port.state_dict().items()})
        out[name] = (cfg, model, params, state, str(path))
    return out


def _step_case(weights, name, family, idx=IDX, mask=MASK, cfg=None, **kw):
    """One step of ``family``'s weights under its config, or ``cfg`` (the
    same shapes: batch size, loss or objective changed)."""
    cfg = cfg or weights[family][0]
    return {"name": name, "kind": "step",
            "cfg": dataclasses.asdict(port_cfg(cfg)),
            "state": weights[family][4], "idx": idx, "mask": mask, "lr": LR,
            "clip": 1e-3, **kw}


AGG = {"name": "agg", "kind": "agg", "seed": 7, "d": 5}
DROP = dict(gcn_drop=0.3, conv_drop=0.2, hidden_drop=0.3, feat_drop=0.2)


def remat_pair(case):
    """``case`` with dropout on (``<name>_drop``) and the same under
    ``--remat`` (``<name>_drop_remat``), checkpoint writing left out."""
    cfg = dict(case["cfg"], **DROP)
    plain = {k: v for k, v in case.items() if k != "ckpt"}
    plain.update(name=case["name"] + "_drop", cfg=cfg)
    return [plain, dict(plain, name=plain["name"] + "_remat",
                        cfg=dict(cfg, remat=True))]


def check_remat_pair(plain_ranks, remat_ranks):
    """Each rank's remat step (loss, gradients, clipped gradients, BN
    statistics, the leaves after one Adam step) equals its plain step to
    the bit; the dropout masks moved the step."""
    for r, (p, q) in enumerate(zip(plain_ranks, remat_ranks)):
        assert p.keys() == q.keys()
        for k in p:
            np.testing.assert_array_equal(q[k], p[k], err_msg=f"rank {r} {k}")


@pytest.fixture(scope="module")
def world_g2(weights, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("g2")
    cases = [AGG, _step_case(weights, "mgcn", "mgcn",
                             ckpt=str(tmp / "ckpt"))] + [
        _step_case(weights, f, f) for f in ("rgcn", "rgcn_block", "rgat")
    ] + remat_pair(_step_case(weights, "mgcn", "mgcn"))
    return cases, _world(tmp, [1, 2], cases), tmp


@pytest.fixture(scope="module")
def world_g4(weights, tmp_path_factory):
    cases = [_step_case(weights, f, f) for f in ("mgcn", "rgcn", "rgat")]
    return cases, _world(tmp_path_factory.mktemp("g4"), [1, 4], cases), None


@pytest.fixture(scope="module")
def world_d2(weights, tmp_path_factory):
    neg = np.random.default_rng(11).integers(0, 12, (8, 5)).tolist()
    mgcn8 = weights["mgcn"][0].replace(batch_size=8)
    cases = ([_step_case(weights, "mgcn8", "mgcn", IDX8, MASK8, mgcn8),
              _step_case(weights, "mgcn8_fused", "mgcn", IDX8, MASK8,
                         mgcn8.replace(loss_impl="fused"))]
             + [_step_case(weights, f"rgcn_neg_{loss}", "rgcn", IDX8, MASK8,
                           weights["rgcn"][0].replace(
                               train_mode="negative_sampling", neg_loss=loss),
                           neg=neg) for loss in NEG_LOSSES])
    return cases, _world(tmp_path_factory.mktemp("d2"), [2, 1], cases), None


@pytest.fixture(scope="module")
def world_d2g2(weights, tmp_path_factory):
    cases = [_step_case(weights, "mgcn8", "mgcn", IDX8, MASK8,
                        weights["mgcn"][0].replace(batch_size=8))]
    return cases, _world(tmp_path_factory.mktemp("d2g2"), [2, 2], cases), None


@pytest.fixture(scope="module")
def reference():
    """The single-process result of a case, computed once."""
    ds, graph, banks = problem()
    memo = {}

    def ref(case):
        if case["name"] not in memo:
            memo[case["name"]] = run_case(case, None, ds, graph, banks)
        return memo[case["name"]]
    return ref


def _grad_close(got, want, name):
    leaf = name.split(".", 1)[1]
    if leaf in DEGENERATE:
        assert max(np.abs(got).max(), np.abs(want).max()) < NOISE, name
        return
    floor = NEAR_NOISE if leaf in NEAR_DEGENERATE else GRAD_FLOOR
    np.testing.assert_allclose(
        got, want, rtol=GRAD_RTOL,
        atol=max(floor, GRAD_ATOL * np.abs(want).max()), err_msg=name)


def _check_step(got, want):
    """One rank's step results against the single-process ones."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for key, w in want.items():
        kind = key.split(".", 1)[0]
        if kind in ("grad", "clipped"):
            _grad_close(got[key], w, key)
        elif kind == "buffer":
            np.testing.assert_allclose(got[key], w, err_msg=key, **BN_TOL)
        elif kind == "param" and key[6:] not in UPDATE_DEGENERATE:
            # Adam's first step is g / (|g| + eps): where |g| nears eps the
            # gradient's float noise moves it by up to lr, so those
            # elements are left out
            g = np.abs(want["grad." + key[6:]])
            keep = g > WELL_CONDITIONED * g.max()
            np.testing.assert_allclose(got[key][keep], w[keep], rtol=0,
                                       atol=UPDATE_ATOL, err_msg=key)
    # the small clip was active, and the step moved the weights
    g, c = want["grad.entity_embedding"], want["clipped.entity_embedding"]
    assert np.abs(c).max() < 0.5 * np.abs(g).max()


def _results(world, name):
    cases, ranks, _ = world
    case = next(c for c in cases if c["name"] == name)
    return case, [{k.split("/", 1)[1]: v for k, v in r.items()
                   if k.startswith(name + "/")} for r in ranks]


# ---------------------------------------------------------------- aggregate

def test_sharded_aggregate_matches_jax_and_single_process(world_g2, toy,
                                                          reference):
    """The 2-rank per-shard aggregate (K1's plain version per shard, then
    the SUM; and the plain compose + index_add_ version): forward and the
    gradients in x, rel_all and the per-edge table, against the port's
    single-process aggregate and JAX's ``make_sharded_aggregate`` (forward
    rtol 1e-5), and against JAX's ``make_pallas_sharded_aggregate`` on 2 of
    the 8 virtual CPU devices in interpret mode, whose MXU product keeps
    each message as two bf16 halves (hi/lo): there at the tolerance of
    tests/test_torch_aggregate.py's kernel comparisons (rtol 1e-4, atol
    1e-5)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kgc_gcn_tpu.parallel.edge_parallel import (
        build_local_csr as jax_local_csr,
        make_pallas_sharded_aggregate as jax_sharded_agg,
        make_sharded_aggregate as jax_plain_agg)
    from kgc_gcn_tpu.parallel.mesh import make_mesh as jax_mesh
    from kgc_gcn_tpu.parallel.mesh import shard_graph as jax_shard_graph

    case, ranks = _results(world_g2, "agg")
    want = reference(case)
    _, jgraph, _ = toy
    rng = np.random.default_rng(case["seed"])
    n, d = jgraph.n_ent, case["d"]
    x, rel_all = (rng.normal(0, 1, s).astype(np.float32)
                  for s in ((n, d), (2 * jgraph.n_rel + 1, d)))
    etab, cot = (rng.normal(0, 1, s).astype(np.float32)
                 for s in ((2, jgraph.e_pad, d), (2, n, d)))
    mesh = jax_mesh(1, 2, devices=jax.devices()[:2])
    sg = jax_shard_graph(jgraph, mesh)
    row = NamedSharding(mesh, P("graph"))
    csr = {h: tuple(jax.device_put(a, row)
                    for a in jax_local_csr(getattr(sg, h), 2))
           for h in ("inb", "outb")}
    kernel_agg = jax_sharded_agg(mesh, n, interpret=True)
    plain_agg = jax_plain_agg(mesh, n)

    def jax_results(f):
        @jax.jit
        def run(x_, r_, e_, c_):
            outs, vjp = jax.vjp(f, x_, r_, e_)
            return outs, vjp((c_[0], c_[1]))

        outs, grads = run(x, rel_all, etab, cot)
        return {"in": outs[0], "out": outs[1], "dx": grads[0],
                "drel": grads[1], "detab": grads[2]}

    jax_kernel = jax_results(lambda x_, r_, e_: (
        kernel_agg(x_, r_, e_[0], sg.inb, csr["inb"]),
        kernel_agg(x_, r_, e_[1], sg.outb, csr["outb"])))
    jax_plain = jax_results(lambda x_, r_, e_: (
        plain_agg(x_, r_, e_[0], sg.inb), plain_agg(x_, r_, e_[1], sg.outb)))
    one = {k[len("kernel."):]: v for k, v in want.items()
           if k.startswith("kernel.")}
    for got in ranks:
        for tag in ("kernel", "plain"):
            for refs, fwd_tol in (((one, jax_plain), dict(rtol=1e-5,
                                                          atol=1e-6)),
                                  ((jax_kernel,), dict(rtol=1e-4,
                                                       atol=1e-5))):
                for ref in refs:
                    for k, w in ref.items():
                        g, w = got[f"{tag}.{k}"], np.asarray(w)
                        if k in ("in", "out"):
                            np.testing.assert_allclose(g, w, err_msg=k,
                                                       **fwd_tol)
                        else:
                            np.testing.assert_allclose(
                                g, w, rtol=GRAD_RTOL,
                                atol=GRAD_ATOL * np.abs(w).max(), err_msg=k)


def test_graph_axis_2_remat_step_equals_plain_step(world_g2):
    """``--remat`` under the edge partition (the recompute's per-slice K1
    sums and their SUM over the graph group run again in the backward),
    dropout on: every rank's remat step equals its plain step to the
    bit."""
    _, plain = _results(world_g2, "mgcn_drop")
    _, remat = _results(world_g2, "mgcn_drop_remat")
    check_remat_pair(plain, remat)
    _, no_drop = _results(world_g2, "mgcn")
    assert not np.array_equal(plain[0]["loss"], no_drop[0]["loss"])


@pytest.mark.parametrize("g_size", [2, 4])
def test_local_csr_matches_jax(toy, g_size):
    """Each shard's local CSR equals the JAX package's, and the shards'
    local halves cover the half's edges once, in order."""
    from kgc_gcn_tpu.parallel.edge_parallel import (
        build_local_csr as jax_local_csr)
    _, jgraph, _ = toy
    _, pgraph, _ = problem()
    for name in ("inb", "outb"):
        got = build_local_csr(getattr(pgraph, name), g_size)
        want = jax_local_csr(getattr(jgraph, name), g_size)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
        half = getattr(pgraph, name)
        parts = [local_half(half, g_size, r) for r in range(g_size)]
        for field in ("src", "dst", "rel", "eid", "norm"):
            np.testing.assert_array_equal(
                torch.cat([getattr(p, field) for p in parts]).numpy(),
                getattr(half, field).numpy())
        assert sum(p.e_real for p in parts) == half.e_real


# ---------------------------------------------------------------- train steps

@pytest.mark.parametrize("family", ["mgcn", "rgcn", "rgcn_block", "rgat"])
def test_graph_axis_2_step_matches_single_process(world_g2, reference,
                                                  family):
    """G = 2: the loss, every gradient (the per-edge table gathered), the
    clipped gradients (a clip of 1e-3, whose norm counts the whole table),
    the BatchNorm statistics and one Adam step equal the single-process
    step, on both ranks."""
    case, ranks = _results(world_g2, family)
    for got in ranks:
        _check_step(got, reference(case))


@pytest.mark.parametrize("family", ["mgcn", "rgcn", "rgat"])
def test_graph_axis_4_step_matches_single_process(world_g4, reference,
                                                  family):
    """G = 4, so that a factor of G in a gradient cannot hide."""
    case, ranks = _results(world_g4, family)
    for got in ranks:
        _check_step(got, reference(case))


def test_mgcn_graph_axis_2_step_matches_jax(world_g2, weights, toy):
    """MGCN + ConvE at G = 2 against the JAX package's single-device step
    (``Trainer._train_step`` with an identity optimizer: grad = (p - new) /
    lr at a large lr)."""
    import jax.numpy as jnp
    import optax

    from kgc_gcn_tpu.train import loop as jloop
    cfg, model, params, state, _ = weights["mgcn"]
    _, jgraph, jbanks = toy
    bank = jbanks["train"]
    q = np.asarray(bank.queries)[IDX]
    li = np.asarray(bank.label_idx)[IDX]
    lr = 1e4
    p0 = {k: np.array(v, copy=True) for k, v in jax_leaves(params).items()}
    trainer = jloop.Trainer(cfg, model, jgraph, jbanks)
    trainer.tx = optax.identity()
    new_p, _, _, j_loss = trainer._train_step_jit(
        params, state, trainer.tx.init(params), jgraph, jnp.float32(lr),
        jnp.asarray(q), jnp.asarray(li), jnp.asarray(MASK, jnp.float32),
        jax.random.PRNGKey(0))
    _, ranks = _results(world_g2, "mgcn")
    for got in ranks:
        np.testing.assert_allclose(got["loss"], float(j_loss), rtol=1e-5)
        for name, v in jax_leaves(new_p).items():
            want = (p0[name].astype(np.float64) - v.astype(np.float64)) / lr
            _grad_close(got[f"grad.{name}"], want, f"grad.{name}")


@pytest.mark.parametrize("name", ["mgcn8", "mgcn8_fused"] + [
    f"rgcn_neg_{loss}" for loss in NEG_LOSSES])
def test_data_axis_2_short_batch_matches_single_process(world_d2, reference,
                                                        name):
    """D = 2 with a short last batch (5 real rows of 8: one rank holds one):
    the loss over the global denominator, gradients summed over the data
    group, ConvE's BatchNorm moments over the global batch, the clip and
    the Adam step equal the single-process step; also with the fused loss
    (K2a / K2b's plain versions, each a mean over its own rows) and with
    each negative-sampling objective on given negatives (R-GCN)."""
    case, ranks = _results(world_d2, name)
    for got in ranks:
        _check_step(got, reference(case))


def test_data_2_by_graph_2_step_matches_single_process(world_d2g2, reference):
    """D = 2 x G = 2: one step on four ranks."""
    case, ranks = _results(world_d2g2, "mgcn8")
    for got in ranks:
        _check_step(got, reference(case))


def test_checkpoint_under_graph_axis_loads_single_process(world_g2, weights,
                                                          reference):
    """The two ranks write ``last.orbax``, each its part: every leaf of
    it, read whole in one process (the per-edge table and its moments
    assembled from both ranks' chunks), equals the single-process
    step's."""
    case, _ = _results(world_g2, "mgcn")
    cfg = port_cfg(weights["mgcn"][0])
    sd, measure, opt = load_checkpoint(case["ckpt"], cfg, with_opt_state=True)
    assert measure == 0.25
    want = reference(case)
    for name, v in sd.items():
        key = f"param.{name}"
        if key in want and name not in UPDATE_DEGENERATE:
            np.testing.assert_allclose(v.numpy(), want[key], rtol=0,
                                       atol=UPDATE_ATOL, err_msg=name)
    ds, graph, _ = problem()
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=graph.e_pad)
    model.load_state_dict(sd)   # one-device shapes
    assert opt.count == 1
    assert tuple(opt.mu[2].shape) == tuple(model.edge_embeddings.shape)
    assert float(opt.mu[2].abs().max()) > 0


# ------------------------------------------------------------ what is refused

def test_stacked_with_use_pallas_under_graph_axis_raises(toy_cfg):
    """As the JAX package: spmm_mode other than halves cannot ride an edge
    partition with use_pallas; a preset's use_pallas yields to it."""
    mesh = Mesh(1, 2, 0, torch.device("cpu"))
    for mode in ("stacked", "stacked_xla"):
        cfg = port_cfg(toy_cfg).replace(use_pallas=True, spmm_mode=mode)
        with pytest.raises(ValueError, match="edge partition"):
            build_model(cfg, 12, 4, 40, mesh=mesh)
        build_model(cfg.replace(use_pallas=False), 12, 4, 40, mesh=mesh)
    args = cli.build_parser().parse_args(
        ["--dataset", "WN18RR", "--spmm_mode", "stacked", "--graph_axis", "2"])
    assert dataset_preset("WN18RR").use_pallas
    assert not cli.config_from_args(args).use_pallas


def test_entity_sharded_still_raises(toy_cfg, tmp_path):
    """What the JAX package refuses of the entity-sharded schedules, the
    port refuses too: a model without a mesh, and the CLI without a graph
    axis (tests/test_torch_entity_sharding.py runs the schedules)."""
    cfg = port_cfg(toy_cfg).replace(entity_sharded="gather")
    with pytest.raises(ValueError, match="needs a .data, graph. mesh"):
        build_model(cfg, 12, 4, 40)
    with pytest.raises(ValueError, match="needs --graph_axis > 1"):
        cli.main(["--dataset", "Toy", "--experiments_dir", str(tmp_path),
                  "--do_train", "--device", "cpu", "--entity_sharded",
                  "boundary"])


# --------------------------------------------------------------------- CLI

_SMALL = ["--gcn_in_dim", "8", "--gcn_out_dim", "32", "--k_w", "4", "--k_h",
          "8", "--num_filter", "4", "--kernel_size", "3", "--device", "cpu",
          "--data_dir", str(ROOT / "data")]


def _test_metrics(log: str):
    line = [l for l in log.splitlines() if "- Test metrics:" in l][-1]
    return dict(kv.split(": ") for kv in
                line.split("metrics: ")[1].strip().split("; "))


def test_cli_two_ranks_with_partition_then_one_process(tmp_path, caplog):
    """``--graph_axis 2 --partition locality`` on two ranks for 2 epochs,
    then ``--do_test`` on rank 0's checkpoint on the two ranks and in one
    process: the same test metrics, and the checkpoint's measure is the
    mesh run's best validation MRR."""
    import logging
    exp = tmp_path / "exp"
    base = ["-m", "kgc_gcn_torch.cli", "--dataset", "Toy",
            "--experiments_dir", str(exp)] + _SMALL
    _launch(base + ["--do_train", "--max_epoch", "2", "--graph_axis", "2",
                    "--partition", "locality"], 2, tmp_path)
    run = exp / "Toy"
    recs = [json.loads(l) for l in (run / "metrics.jsonl").read_text()
            .splitlines()]
    best = max(r["val"]["mrr"] for r in recs if "val" in r)
    assert json.loads((run / "params.json").read_text())["partition"] \
        == "locality"
    _launch(base + ["--do_test", "--restore_dir", str(run),
                    "--graph_axis", "2"], 2, tmp_path)
    mesh_metrics = _test_metrics((run / "train.log").read_text())
    with caplog.at_level(logging.INFO):
        assert cli.main(["--dataset", "Toy", "--experiments_dir",
                         str(tmp_path / "one"), "--do_test", "--restore_dir",
                         str(run)] + _SMALL) == 0
    line = next(r.getMessage() for r in caplog.records
                if "Test metrics" in r.getMessage())
    one = dict(kv.split(": ") for kv in
               line.split("metrics: ")[1].strip().split("; "))
    assert one == mesh_metrics
    _, measure = load_checkpoint(str(run), Config.from_json(
        str(run / "params.json")))
    assert measure == pytest.approx(best, abs=1e-6)
