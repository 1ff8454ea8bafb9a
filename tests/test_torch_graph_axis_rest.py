"""The rest of the port's edge-partitioned path on the CPU: the sampled
aggregate and the bench's reference schedule on edge slices
(parallel/edge_parallel.py, ops/sampler.py:take_slice, models/mgcn.py), the
orbax checkpoint written rank by rank and restored on any mesh
(train/checkpoint.py, train/orbax_layout.py) and ``--do_predict`` under a
launcher (cli.py).

One gloo world of two graph ranks (tests/torch_parallel_worker.py, which
imports no JAX) runs every case once per module; the CLI runs on two ranks
twice.  Every rank has OMP_NUM_THREADS=1, a free port and a timeout
(tests/test_torch_parallel.py's launcher).  Tolerances: the aggregates'
forward values rtol 1e-5 (float32 sums in another order), their gradients
rtol 2e-4 and atol 2e-5 of the tensor's largest; the steps those of
tests/test_torch_parallel.py; checkpoint leaves bit for bit; served scores
1e-5, ids equal where neighbouring scores lie further apart.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kgc_gcn_tpu.ops.sampler import aggregate_sampled_half as jax_sampled
from kgc_gcn_tpu.ops.sampler import sample_half as jax_sample_half
from kgc_gcn_tpu.ops.scatter import (
    aggregate_half_reference_schedule as jax_reference_schedule)
from kgc_gcn_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from kgc_gcn_tpu.train.optim import make_optimizer

from kgc_gcn_torch import cli
from kgc_gcn_torch.config import Config
from kgc_gcn_torch.convert import module_key
from kgc_gcn_torch.train.checkpoint import load_checkpoint
from test_torch_common import jax_and_port_models, jax_leaves, port_cfg
from test_torch_parallel import (
    GRAD_ATOL, GRAD_RTOL, ROOT, _SMALL, _check_step, _launch, _no_dropout,
    _results, _world)
from torch_parallel_worker import problem, run_case

K = 24      # sampled edges a half, of the toy's 40
LR = 0.01


@pytest.fixture(scope="module")
def mgcn(toy, toy_cfg, tmp_path_factory):
    """(JAX config, JAX params, state, port weights file) of MGCN + ConvE,
    dropout off."""
    cfg = _no_dropout(toy_cfg)
    _, params, state, port = jax_and_port_models(toy, cfg, seed=3)
    path = tmp_path_factory.mktemp("weights") / "mgcn.npz"
    np.savez(path, **{k: v.numpy() for k, v in port.state_dict().items()})
    return cfg, params, state, str(path)


def _positions(seed: int, n_edge: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n_edge, K).tolist() for _ in range(2)]


@pytest.fixture(scope="module")
def world(mgcn, tmp_path_factory):
    """One world of two graph ranks: the aggregates, a sampled step (which
    writes its checkpoint), a reference-schedule step, then the restore of
    that checkpoint."""
    tmp = tmp_path_factory.mktemp("g2_rest")
    cfg = mgcn[0]
    n_edge = problem()[0].num_edge
    step = lambda name, c, **kw: {
        "name": name, "kind": "step", "cfg": dataclasses.asdict(port_cfg(c)),
        "state": mgcn[3], "idx": [5, 2, 7, 0], "mask": [1, 1, 1, 0],
        "lr": LR, "clip": 1e-3, **kw}
    cases = [
        {"name": "agg", "kind": "rest_agg", "seed": 7, "d": 5, "d_out": 6,
         "positions": _positions(8, n_edge)},
        step("sampled", cfg.replace(edge_sample_size=K),
             positions=_positions(9, n_edge), ckpt=str(tmp / "ckpt")),
        step("reference", cfg.replace(agg_schedule="reference")),
        {"name": "restore", "kind": "restore", "path": str(tmp / "ckpt"),
         "cfg": dataclasses.asdict(port_cfg(cfg))}]
    return cases, _world(tmp, [1, 2], cases), tmp


@pytest.fixture(scope="module")
def single():
    """The single-process result of a case, computed once."""
    ds, graph, banks = problem()
    memo = {}

    def ref(case):
        if case["name"] not in memo:
            memo[case["name"]] = run_case(case, None, ds, graph, banks)
        return memo[case["name"]]
    return ref


@pytest.mark.parametrize("name", ["sampled", "reference"])
def test_graph_axis_2_step_matches_single_process(world, single, name):
    """G = 2 with ``edge_sample_size`` K on given positions (each rank keeps
    the drawn edges of its slice) and with ``agg_schedule=reference``: the
    loss, every gradient (the per-edge table gathered), the clipped
    gradients, the BatchNorm statistics and one Adam step equal the
    single-process step, on both ranks."""
    case, ranks = _results(world, name)
    for got in ranks:
        _check_step(got, single(case))


def test_aggregates_match_jax_and_single_process(world, single, toy,
                                                 monkeypatch):
    """The two-rank sampled aggregate and reference schedule, both halves:
    forward and gradients against the port's single process and JAX's
    ``aggregate_sampled_half`` (on JAX ``sample_half``'s take of the same
    positions) and ``aggregate_half_reference_schedule``; a rank's
    per-edge gradient lies in its own slice only."""
    case, ranks = _results(world, "agg")
    one = single(case)
    _, jgraph, _ = toy
    rng = np.random.default_rng(case["seed"])
    n, d, d_out = jgraph.n_ent, case["d"], case["d_out"]
    normal = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    x, rel, etab = normal(n, d), normal(2 * jgraph.n_rel + 1, d), normal(
        2, jgraph.e_pad, d)
    w_in, w_out, cot, cot_ref = (normal(d, d_out), normal(d, d_out),
                                 normal(2, n, d), normal(2, n, d_out))
    halves = (jgraph.inb, jgraph.outb)
    draws = iter(case["positions"])
    monkeypatch.setattr(jax.random, "randint", lambda *a: jnp.asarray(
        next(draws), jnp.int32))
    samples = [jax_sample_half(None, h, K, jgraph.n_edge) for h in halves]

    def vjp(f, args, c):
        outs, back = jax.vjp(f, *args)
        return outs, back((jnp.asarray(c[0]), jnp.asarray(c[1])))

    outs, grads = vjp(lambda a, b, e: tuple(
        jax_sampled(a, b, e[i], s, n) for i, s in enumerate(samples)),
        (x, rel, etab), cot)
    jax_res = {"sampled": dict(zip(("in", "out", "dx", "drel", "detab"),
                                   (*outs, *grads)))}
    outs, grads = vjp(lambda a, b, e, wi, wo: tuple(
        jax_reference_schedule(a, b, e[i], h, w, n)
        for i, (h, w) in enumerate(zip(halves, (wi, wo)))),
        (x, rel, etab, w_in, w_out), cot_ref)
    jax_res["reference"] = dict(zip(
        ("in", "out", "dx", "drel", "detab", "dw_in", "dw_out"),
        (*outs, *grads)))
    for got in ranks:
        for tag, want_jax in jax_res.items():
            assert float(got[f"{tag}.foreign"]) == 0.0, tag
            for k, w in want_jax.items():
                for ref in (np.asarray(w), one[f"{tag}.{k}"]):
                    g = got[f"{tag}.{k}"]
                    if k in ("in", "out"):
                        np.testing.assert_allclose(g, ref, rtol=1e-5,
                                                   atol=1e-6,
                                                   err_msg=f"{tag}.{k}")
                    else:
                        np.testing.assert_allclose(
                            g, ref, rtol=GRAD_RTOL,
                            atol=GRAD_ATOL * np.abs(ref).max(),
                            err_msg=f"{tag}.{k}")


def test_each_rank_writes_only_its_own_chunks(world):
    """``last.orbax`` on two graph ranks: graph rank g writes the chunk
    ``0.g.0`` of the per-edge table and of both Adam moments; rank 0 also
    every replicated leaf, the measure and the metadata, rank 1 nothing
    else."""
    _, ranks = _results(world, "sampled")
    tables = ("tree.params.edge_embeddings", "tree.opt_state.1.mu."
              "edge_embeddings", "tree.opt_state.1.nu.edge_embeddings")
    for g, got in enumerate(ranks):
        written = [str(f) for f in got["written"]]
        own = sorted(f"{t}/0.{g}.0" for t in tables)
        assert sorted(f for f in written if f.startswith(tables)
                      and not f.endswith(".zarray")) == own
        if g:
            assert written == own
        else:
            assert "_METADATA" in written and "__measure__/0" in written
            assert "tree.params.entity_embedding/0.0" in written


def test_jax_restores_the_two_rank_checkpoint(world, mgcn, toy):
    """The JAX package's ``load_checkpoint`` reads the directory the two
    ranks wrote: the measure, every parameter (equal to the ranks' stepped
    weights, bit for bit), every BN statistic and the Adam state equal the
    port's one-process read of it."""
    cfg, params, state, _ = mgcn
    _, ranks = _results(world, "sampled")
    path = world[2] / "ckpt"
    tree, measure = jax_load_checkpoint(str(path), {
        "params": params, "state": state,
        "opt_state": make_optimizer(cfg).init(params)})
    sd, ours, opt = load_checkpoint(str(path), port_cfg(cfg),
                                    with_opt_state=True)
    assert measure == ours == 0.25
    stepped = jax_leaves(tree["params"])
    for name, v in stepped.items():
        np.testing.assert_array_equal(v, sd[name].numpy(), err_msg=name)
        np.testing.assert_array_equal(v, ranks[0][f"param.{name}"],
                                      err_msg=name)
    for name, v in jax_leaves(tree["state"]).items():
        np.testing.assert_array_equal(v, sd[module_key(name)].numpy(),
                                      err_msg=name)
    adam = tree["opt_state"][-1]
    assert int(adam.count) == opt.count == 1
    for moments, mine in ((adam.mu, opt.mu), (adam.nu, opt.nu)):
        for v, t in zip(jax.tree.leaves(moments), mine):
            np.testing.assert_array_equal(np.asarray(v), t.numpy())


def test_port_restores_on_one_process_and_on_two_ranks(world, mgcn):
    """The port's ``load_checkpoint`` of the two-rank directory on each
    rank (its slice of the per-edge table and moments, gathered here) and
    in one process: the same leaves, measure and step count."""
    _, ranks = _results(world, "restore")
    cfg = port_cfg(mgcn[0])
    sd, measure, opt = load_checkpoint(str(world[2] / "ckpt"), cfg,
                                       with_opt_state=True)
    names = list(jax_leaves(mgcn[1]))
    for got in ranks:
        assert float(got["measure"]) == measure and int(got["count"]) == 1
        for k, v in sd.items():
            np.testing.assert_array_equal(got[f"sd.{k}"], v.numpy(),
                                          err_msg=k)
        for tag, moments in (("mu", opt.mu), ("nu", opt.nu)):
            for name, t in zip(names, moments):
                np.testing.assert_array_equal(got[f"{tag}.{name}"],
                                              t.float().numpy(), err_msg=name)


def test_cli_predict_on_two_ranks_matches_one_process(tmp_path, capsys):
    """One epoch on two ranks with ``--graph_axis 2 --ckpt_every 1`` writes
    ``last.orbax`` and ``periodic.orbax``; ``--do_predict`` from it on two
    ranks prints on rank 0 alone the lines one process prints: the same
    queries, scores within 1e-5, ids equal where neighbouring scores lie
    further apart."""
    exp = tmp_path / "exp"
    base = ["-m", "kgc_gcn_torch.cli", "--dataset", "Toy",
            "--experiments_dir", str(exp)] + _SMALL
    _launch(base + ["--do_train", "--max_epoch", "1", "--graph_axis", "2",
                    "--ckpt_every", "1"], 2, tmp_path)
    run = exp / "Toy"
    assert {"last.orbax", "periodic.orbax"} <= {p.name
                                                for p in run.iterdir()}
    assert not (run / "last.ckpt").exists()
    queries = tmp_path / "q.txt"
    lines = (ROOT / "data" / "Toy" / "test.txt").read_text().splitlines()
    queries.write_text("".join("\t".join(l.split("\t")[:2]) + "\n"
                               for l in lines))
    serve = ["--do_predict", "--predict_file", str(queries),
             "--restore_dir", str(run), "--top_k", "5"]
    (_, out0, _), (_, out1, _) = _launch(base + serve + ["--graph_axis",
                                                         "2"], 2, tmp_path)
    assert out1.strip() == ""
    assert cli.main(["--dataset", "Toy", "--experiments_dir",
                     str(tmp_path / "one")] + _SMALL + serve) == 0
    one = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    two = [json.loads(l) for l in out0.splitlines()]
    assert len(one) == len(two) == len(lines)
    for a, b in zip(two, one):
        assert (a["subject"], a["relation"]) == (b["subject"], b["relation"])
        sa = np.array([e["score"] for e in a["topk"]])
        sb = np.array([e["score"] for e in b["topk"]])
        np.testing.assert_allclose(sa, sb, rtol=0, atol=1e-5)
        apart = np.abs(np.diff(sb)) > 1e-5
        keep = np.concatenate([[True], apart]) & np.concatenate([apart,
                                                                 [True]])
        ids = lambda r: np.array([e["entity"] for e in r["topk"]])
        np.testing.assert_array_equal(ids(a)[keep], ids(b)[keep])
    _, measure = load_checkpoint(str(run / "periodic.orbax"),
                                 Config.from_json(str(run / "params.json")))
    assert measure == 0.0
