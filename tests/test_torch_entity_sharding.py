"""The port's entity-sharded schedules on the CPU (kgc_gcn_torch/parallel/
{entity_sharding,boundary,edge_parallel,distributed}.py and the
entity-sharded encoders of models/{mgcn,rgcn,rgat}.py): gloo ranks in
subprocesses (tests/torch_parallel_worker.py, which imports no JAX), one
world per graph axis launched once per module, against the single-process
aggregate and step on the same inputs and weights and against the JAX
package.

The corpus is the toy one with 13 entities, which neither 2 nor 4 ranks
divide, so the last rank holds padding rows.  Weights come from the JAX
models of tests/test_torch_common.py (seeded); dropout is off in the steps.
The host plans are held field for field against JAX's ``build_local_csr``
(``n_rows_out``), ``build_ring_blocks`` and ``build_boundary_plan`` (its
``stats`` too).  Tolerances, as tests/test_torch_parallel.py's: forward
values rtol 1e-5; gradients rtol 2e-4, atol 2e-5 of the tensor's largest
gradient (floor 1e-7; the directions that BatchNorm cancels held to noise);
BatchNorm statistics rtol 1e-5; the updated weights atol 1e-3 of the
learning rate.  The JAX package's schedules run plain (XLA) on 2 of the 8
virtual CPU devices; its interpret-mode kernel forms are not run here (the
card holds the port's kernel forms against its plain forms:
tests/test_torch_cuda.py and chip_smoke.py phase 15).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgc_gcn_torch import cli
from kgc_gcn_torch.config import Config
from kgc_gcn_torch.models import build_model
from kgc_gcn_torch.parallel.boundary import build_boundary_plan
from kgc_gcn_torch.parallel.edge_parallel import (
    build_local_csr, build_ring_blocks)
from kgc_gcn_torch.parallel.entity_sharding import (
    EntityRows, EntityShardedAggregator)
from kgc_gcn_torch.parallel.mesh import Mesh
from test_torch_common import (
    jax_and_port_models, jax_leaves, port_cfg, rgat_cfg, rgcn_cfg)
from test_torch_parallel import (
    GRAD_ATOL, GRAD_RTOL, IDX, LR, MASK, WORKER, _check_step, _finish,
    _grad_close, _no_dropout, _start, check_remat_pair, remat_pair)
from torch_parallel_worker import problem, run_case

N_ENT = 13
ROOT = WORKER.parents[1]
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
SCHEDULES = ("gather", "ring", "boundary")
COLLECTIVES = ("all_gather_rows", "reduce_scatter_rows", "gather_from_group",
               "scatter_to_group", "ppermute")


@pytest.fixture(scope="module")
def toy13():
    """The JAX package's (dataset, graph, banks) of the 13-entity corpus."""
    from kgc_gcn_tpu.data.batching import make_banks
    from kgc_gcn_tpu.data.dataset import build_dataset
    from kgc_gcn_tpu.data.graph import build_graph
    from kgc_gcn_tpu.data.toy import toy_triples
    train, valid, test = toy_triples(n_ent=N_ENT, n_rel=4, n_train=40)
    ds = build_dataset("toy", train, valid, test)
    graph = build_graph(ds.train_triples, ds.num_entity, ds.num_relation,
                        pad_to=8)
    return ds, graph, make_banks(ds)


@pytest.fixture(scope="module")
def weights(toy13, toy_cfg, tmp_path_factory):
    """{family: (JAX config, JAX model, params, state, port weights file)}:
    MGCN + ConvE with 1 and 2 layers, basis R-GCN and RGAT + DistMult."""
    tmp = tmp_path_factory.mktemp("es_weights")
    mgcn = _no_dropout(toy_cfg)
    cfgs = {"mgcn": mgcn, "mgcn2": mgcn.replace(num_layers=2),
            "rgcn": rgcn_cfg(toy_cfg), "rgat": rgat_cfg(toy_cfg)}
    out = {}
    for name, cfg in cfgs.items():
        model, params, state, port = jax_and_port_models(toy13, cfg, seed=5)
        path = tmp / f"{name}.npz"
        np.savez(path, **{k: v.numpy() for k, v in port.state_dict().items()})
        out[name] = (cfg, model, params, state, str(path))
    return out


def _step(weights, family, schedule, g, pallas=False):
    cfg = port_cfg(weights[family][0]).replace(
        entity_sharded=schedule, graph_axis=g, use_pallas=pallas)
    return {"name": f"{family}_{schedule}{'_k1' if pallas else ''}",
            "kind": "step", "cfg": dataclasses.asdict(cfg),
            "state": weights[family][4], "idx": IDX, "mask": MASK, "lr": LR,
            "clip": 1e-3}


def _aggs():
    return [{"name": f"agg_{c}_{s}", "kind": "es_agg", "seed": 9, "d": 5,
             "schedule": s, "compose": c,
             "forms": ["plain", "kernel"] if c == "mult" and s != "ring"
             else ["plain"]}
            for c in ("mult", "basis") for s in SCHEDULES]


STEPS = {
    2: [("mgcn", "gather", True), ("mgcn", "boundary", True),
        ("mgcn", "ring", False), ("mgcn2", "boundary", True),
        ("rgcn", "gather", False), ("rgcn", "ring", False),
        ("rgcn", "boundary", False), ("rgat", "gather", True)],
    4: [("mgcn", "ring", False), ("mgcn", "boundary", True),
        ("mgcn2", "gather", True), ("rgcn", "ring", False),
        ("rgcn", "boundary", False), ("rgat", "gather", False)],
}


@pytest.fixture(scope="module")
def worlds(weights, tmp_path_factory):
    """Each world's cases by name, with every rank's results; the worlds
    of 2 and 4 ranks run side by side."""
    started = {}
    for g in (2, 4):
        tmp = tmp_path_factory.mktemp(f"es_g{g}")
        cases = ([{"name": "coll", "kind": "coll"}] + _aggs()
                 + [_step(weights, f, s, g, k) for f, s, k in STEPS[g]]
                 + (remat_pair(_step(weights, "mgcn", "boundary", g, True))
                    if g == 2 else []))
        spec = tmp / "spec.json"
        spec.write_text(json.dumps({"mesh": [1, g], "n_ent": N_ENT,
                                    "cases": cases}))
        started[g] = (tmp, cases, _start([str(WORKER), str(spec), str(tmp)],
                                         g, ROOT))
    out = {}
    for g, (tmp, cases, procs) in started.items():
        _finish(procs)
        ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(g)]
        out[g] = {c["name"]: (c, [{k.split("/", 1)[1]: v
                                   for k, v in r.items()
                                   if k.startswith(c["name"] + "/")}
                                  for r in ranks]) for c in cases}
    return out


@pytest.fixture(scope="module")
def reference():
    """The single-process result of a case, computed once."""
    ds, graph, banks = problem(N_ENT)
    memo = {}

    def ref(case):
        if case["name"] not in memo:
            memo[case["name"]] = run_case(case, None, ds, graph, banks)
        return memo[case["name"]]
    return ref


def _close_agg(got, want, what):
    for k, w in want.items():
        g = got[k]
        if k in ("in", "out"):
            np.testing.assert_allclose(g, w, err_msg=f"{what} {k}", **FWD_TOL)
        else:
            np.testing.assert_allclose(
                g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL * np.abs(w).max(),
                err_msg=f"{what} {k}")


# ------------------------------------------------------------- host plans

@pytest.mark.parametrize("g_size", [2, 4])
@pytest.mark.parametrize("plan", ["local_csr", "ring", "boundary"])
def test_host_plans_match_jax(toy13, g_size, plan):
    """Each half's plan equals the JAX package's field for field:
    ``build_local_csr`` over the ``n_pad`` padded rows, ``build_ring_blocks``
    and ``build_boundary_plan`` (its per-step arrays, steps, sizes and
    ``stats``)."""
    from kgc_gcn_tpu.parallel import boundary as jb
    from kgc_gcn_tpu.parallel import edge_parallel as je
    _, jgraph, _ = toy13
    _, pgraph, _ = problem(N_ENT)
    n_pad = -(-N_ENT // g_size) * g_size
    if plan == "boundary":   # the aggregator's stats are the plans'
        es = EntityShardedAggregator(
            Config(entity_sharded="boundary"),
            Mesh(1, g_size, 0, torch.device("cpu")), N_ENT)
        es.prepare(pgraph)
        assert es.boundary_stats == {
            name: jb.build_boundary_plan(getattr(jgraph, name), g_size,
                                         n_pad)[1]
            for name in ("inb", "outb")}
    for name in ("inb", "outb"):
        jh, ph = getattr(jgraph, name), getattr(pgraph, name)
        if plan == "local_csr":
            pairs = zip(build_local_csr(ph, g_size, n_pad),
                        je.build_local_csr(jh, g_size, n_rows_out=n_pad))
        elif plan == "ring":
            pairs = zip(build_ring_blocks(ph, g_size, n_pad),
                        je.build_ring_blocks(jh, g_size, n_pad))
        else:
            got, got_stats = build_boundary_plan(ph, g_size, n_pad)
            want, want_stats = jb.build_boundary_plan(jh, g_size, n_pad)
            assert got_stats == want_stats
            pairs = []
            for f in dataclasses.fields(want):
                a, b = getattr(got, f.name), getattr(want, f.name)
                if f.name in ("t_steps", "k_steps", "d_max", "rows_per"):
                    assert a == b, f.name
                elif isinstance(b, tuple):
                    assert len(a) == len(b), f.name
                    pairs += list(zip(a, b))
                else:
                    pairs.append((a, b))
        for a, b in pairs:
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))


# -------------------------------------------------------------- collectives

@pytest.mark.parametrize("what", COLLECTIVES)
def test_collectives_and_their_backward_rules(worlds, what):
    """Each new collective's forward and its backward rule on every rank,
    at G 2 and 4, against the values it must give (the worker's ``coll``
    case: rank-tagged rows, a cotangent of its own per rank)."""
    for g, world in worlds.items():
        _, ranks = world["coll"]
        for r, got in enumerate(ranks):
            np.testing.assert_array_equal(got[f"{what}.fwd"],
                                          got[f"{what}.fwd_want"],
                                          err_msg=f"G {g} rank {r}")
            np.testing.assert_array_equal(got[f"{what}.bwd"],
                                          got[f"{what}.bwd_want"],
                                          err_msg=f"G {g} rank {r}")


# ---------------------------------------------------------------- aggregates

def _jax_inputs(case, jgraph):
    rng = np.random.default_rng(case["seed"])
    d, n, nb = case["d"], jgraph.n_ent, case.get("nb", 3)
    basis = case["compose"] == "basis"
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    rel = rng.normal(0, 1, (2 * jgraph.n_rel, nb) if basis
                     else (2 * jgraph.n_rel + 1, d)).astype(np.float32)
    etab = rng.normal(0, 1, (2, jgraph.e_pad, d)).astype(np.float32)
    cot = rng.normal(0, 1, (2, n, nb * d if basis else d)).astype(np.float32)
    return x, rel, etab, cot


def _jax_results(f, x, rel, etab, cot):
    @jax.jit
    def run(x_, r_, e_, c_):
        outs, vjp = jax.vjp(f, x_, r_, e_)
        return outs, vjp((c_[0], c_[1]))

    (o_in, o_out), (gx, gr, ge) = run(x, rel, etab, cot)
    return {"in": np.asarray(o_in), "out": np.asarray(o_out),
            "dx": np.asarray(gx), "drel": np.asarray(gr),
            "detab": np.asarray(ge)}


def _jax_single(case, jgraph):
    """JAX's single-device aggregate of both halves (plain)."""
    from kgc_gcn_tpu.models.rgcn import basis_compose
    from kgc_gcn_tpu.ops.scatter import aggregate_half
    n = jgraph.n_ent

    def f(x, r, e):
        if case["compose"] == "mult":
            return tuple(aggregate_half(x, r, e[i], h, n)
                         for i, h in enumerate((jgraph.inb, jgraph.outb)))
        return tuple(jax.ops.segment_sum(
            basis_compose(x[h.src], r, h.rel, None, h.norm), h.dst,
            num_segments=n, indices_are_sorted=True)
            for h in (jgraph.inb, jgraph.outb))
    return _jax_results(f, *_jax_inputs(case, jgraph))


@pytest.fixture(scope="module")
def jax_single(toy13):
    """JAX's single-device aggregate of a case's inputs, computed once per
    compose (the aggregate cases share their inputs)."""
    memo = {}

    def single(case):
        if case["compose"] not in memo:
            memo[case["compose"]] = _jax_single(case, toy13[1])
        return memo[case["compose"]]
    return single


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("compose", ["mult", "basis"])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_aggregate_matches_single_process_and_jax(worlds, reference,
                                                  jax_single, g, compose,
                                                  schedule):
    """Each schedule's aggregate of both halves (MGCN's compose, plain and
    on K1's plain version; R-GCN's basis compose, plain): forward and the
    gradients in x, the relation table and the per-edge table, on every
    rank, against the port's single-process aggregate and JAX's
    single-device one."""
    case, ranks = worlds[g][f"agg_{compose}_{schedule}"]
    one = {k.split(".", 1)[1]: v for k, v in reference(case).items()
           if k.startswith("plain.")}
    jx = jax_single(case)
    for r, got in enumerate(ranks):
        for tag in case["forms"]:
            mine = {k.split(".", 1)[1]: v for k, v in got.items()
                    if k.startswith(tag + ".")}
            for want, of in ((one, "single process"), (jx, "JAX")):
                _close_agg(mine, want, f"G {g} rank {r} {tag} vs {of}")


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_aggregate_g2_matches_jax_schedule(worlds, toy13, toy_cfg, schedule):
    """At G 2, each schedule against the JAX package's own (its
    ``EntityShardedAggregator``, plain, on 2 virtual CPU devices), MGCN's
    compose and R-GCN's basis compose."""
    from kgc_gcn_tpu.models.rgcn import basis_compose
    from kgc_gcn_tpu.parallel.entity_sharding import (
        EntityShardedAggregator as JaxAggregator)
    from kgc_gcn_tpu.parallel.mesh import make_mesh, shard_graph
    _, jgraph, _ = toy13
    mesh = make_mesh(1, 2, devices=jax.devices()[:2])
    sg = shard_graph(jgraph, mesh)
    for compose in ("mult", "basis"):
        case, ranks = worlds[2][f"agg_{compose}_{schedule}"]
        cfg = toy_cfg.replace(entity_sharded=schedule, use_pallas=False,
                              graph_axis=2)
        es = JaxAggregator(cfg, mesh, jgraph.n_ent,
                           None if compose == "mult" else basis_compose)
        es.prepare(sg)
        ones = jnp.ones((2, jgraph.e_pad, 1), jnp.float32)
        want = _jax_results(
            lambda x, r, e: es.agg_pair(
                x, r, e if compose == "mult" else ones, sg),
            *_jax_inputs(case, jgraph))
        if compose == "basis":
            want["detab"] = np.zeros_like(want["detab"])
        for r, got in enumerate(ranks):
            for tag in case["forms"]:
                mine = {k.split(".", 1)[1]: v for k, v in got.items()
                        if k.startswith(tag + ".")}
                _close_agg(mine, want, f"{compose} rank {r} {tag}")


# ---------------------------------------------------------------- train steps

@pytest.mark.parametrize("g,family,schedule,pallas", [
    (g, *c) for g in (2, 4) for c in STEPS[g]])
def test_entity_sharded_step_matches_single_process(worlds, reference, g,
                                                    family, schedule, pallas):
    """One step under entity sharding (MGCN with 1 and 2 layers, with
    use_pallas on gather and boundary; basis R-GCN; RGAT on gather): the
    loss, every gradient (the per-edge table gathered), the clipped
    gradients, the BatchNorm statistics (the encoder's over the real rows)
    and one Adam step equal the single-process step, on every rank."""
    case, ranks = worlds[g][
        f"{family}_{schedule}{'_k1' if pallas else ''}"]
    for got in ranks:
        _check_step(got, reference(case))


def test_entity_sharded_remat_step_equals_plain_step(worlds):
    """``--remat`` on the ``boundary`` schedule at G 2 with K1 (the
    recompute's boundary exchanges, BatchNorm moments over the group and
    the gather of the rows run again in the backward), dropout on: every
    rank's remat step equals its plain step to the bit."""
    _, plain = worlds[2]["mgcn_boundary_k1_drop"]
    _, remat = worlds[2]["mgcn_boundary_k1_drop_remat"]
    check_remat_pair(plain, remat)
    _, no_drop = worlds[2]["mgcn_boundary_k1"]
    assert not np.array_equal(plain[0]["loss"], no_drop[0]["loss"])


@pytest.mark.parametrize("family,schedule", [
    ("mgcn", "gather_k1"), ("mgcn2", "boundary_k1"), ("rgcn", "ring"),
    ("rgat", "gather_k1")])
def test_entity_sharded_step_matches_jax(worlds, weights, toy13, family,
                                         schedule):
    """The G 2 step against the JAX package's single-device step
    (``Trainer._train_step`` with an identity optimizer: grad = (p - new) /
    lr at a large lr)."""
    import optax

    from kgc_gcn_tpu.train import loop as jloop
    cfg, model, params, state, _ = weights[family]
    _, jgraph, jbanks = toy13
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
    _, ranks = worlds[2][f"{family}_{schedule}"]
    for got in ranks:
        np.testing.assert_allclose(got["loss"], float(j_loss), rtol=1e-5)
        for name, v in jax_leaves(new_p).items():
            want = (p0[name].astype(np.float64) - v.astype(np.float64)) / lr
            _grad_close(got[f"grad.{name}"], want, f"grad.{name}")


@pytest.mark.parametrize("g", [2, 4])
def test_entity_rows_dropout_draws_the_one_process_masks(g):
    """Each rank's dropout of its block of rows draws the masks of the
    whole N rows from the shared stream and keeps its rows: the blocks of
    every rank make the one-process dropout (padding rows 0)."""
    from kgc_gcn_torch.models.common import dropout
    x = torch.randn(N_ENT, 6, generator=torch.Generator().manual_seed(1))
    want = dropout(x, 0.3, torch.Generator().manual_seed(7), True)
    parts = []
    for r in range(g):
        rows = EntityRows(Mesh(1, g, r, torch.device("cpu")), N_ENT)
        lo = r * rows.rows_per
        x_loc = torch.nn.functional.pad(
            x[lo:lo + rows.n_real], (0, 0, 0, rows.rows_per - rows.n_real))
        parts.append(rows.dropout(x_loc, 0.3,
                                  torch.Generator().manual_seed(7), True))
    got = torch.cat(parts)
    assert torch.equal(got[:N_ENT], want)
    assert not got[N_ENT:].any()


# ------------------------------------------------------------ what is refused

@pytest.mark.parametrize("what", ["rgat_ring", "rgat_boundary", "rgcn_block",
                                  "pallas_ring", "graph_axis_1", "no_mesh"])
def test_entity_sharded_refusals_match_jax(toy_cfg, what):
    """The JAX package's refusals: RGAT with ring or boundary, R-GCN block
    mode, use_pallas with the ring, a graph axis below 2 (the aggregator
    and the CLI), and a model without a mesh."""
    mesh2 = Mesh(1, 2, 0, torch.device("cpu"))
    mgcn = port_cfg(toy_cfg)
    if what.startswith("rgat_"):
        cfg = port_cfg(rgat_cfg(toy_cfg)).replace(
            entity_sharded=what.split("_")[1])
        with pytest.raises(ValueError, match="gather' only"):
            build_model(cfg, N_ENT, 4, 40, mesh=mesh2)
    elif what == "rgcn_block":
        cfg = port_cfg(rgcn_cfg(toy_cfg, num_bases=0, num_blocks=4)).replace(
            entity_sharded="gather")
        with pytest.raises(ValueError, match="basis decomposition only"):
            build_model(cfg, N_ENT, 4, 40, mesh=mesh2)
    elif what == "pallas_ring":
        cfg = mgcn.replace(entity_sharded="ring", use_pallas=True)
        with pytest.raises(ValueError, match=r"\['use_pallas'\]"):
            build_model(cfg, N_ENT, 4, 40, mesh=mesh2)
        for s in ("gather", "boundary"):   # the kernel schedules take it
            build_model(cfg.replace(entity_sharded=s), N_ENT, 4, 40,
                        mesh=mesh2)
    elif what == "graph_axis_1":
        cfg = mgcn.replace(entity_sharded="gather")
        with pytest.raises(ValueError, match="graph axis > 1"):
            EntityShardedAggregator(cfg, Mesh(1, 1, 0, torch.device("cpu")),
                                    N_ENT)
        with pytest.raises(ValueError, match="needs --graph_axis > 1"):
            cli.main(["--dataset", "Toy", "--do_train", "--device", "cpu",
                      "--entity_sharded", "boundary"])
    else:
        for cfg in (mgcn, port_cfg(rgcn_cfg(toy_cfg)),
                    port_cfg(rgat_cfg(toy_cfg))):
            with pytest.raises(ValueError, match="needs a .data, graph. mesh"):
                build_model(cfg.replace(entity_sharded="gather"), N_ENT, 4,
                            40)


def test_cli_preset_use_pallas_yields_to_ring_and_boundary():
    """A preset's use_pallas (WN18RR) yields to ring and boundary, as in the
    JAX CLI; gather keeps it."""
    for schedule, kept in (("ring", False), ("boundary", False),
                           ("gather", True)):
        args = cli.build_parser().parse_args(
            ["--dataset", "WN18RR", "--graph_axis", "2", "--entity_sharded",
             schedule])
        assert cli.config_from_args(args).use_pallas is kept
    assert isinstance(Config().entity_sharded, str)
