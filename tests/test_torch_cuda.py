"""Tests of the port that need an NVIDIA card: each CUDA kernel against its
plain PyTorch version on the card, the encoder through the kernels, the
RGAT attention wrappers' gradients through K1, and one training step through
the kernels against the same step in plain PyTorch (MGCN 1-vs-all, also
under each aggregation schedule; R-GCN on sampled negatives, RGAT
1-vs-all).

This file imports neither JAX nor kgc_gcn_tpu, so that it runs on a machine
with a card and no JAX (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test here skips.  The CSR inputs are shared with
tests/test_torch_segment_sum.py, which holds the plain version against the
JAX package on the CPU.
"""

import numpy as np
import pytest
import torch

from kgc_gcn_torch.ops.basis import (
    BASIS_BWD_MAX_SMEM, basis_backward, basis_backward_reference,
    basis_segment_sum, basis_segment_sum_reference)
from kgc_gcn_torch.ops.fused_loss import (
    dense_grads, dense_grads_reference, dense_loss, dense_loss_reference)
from kgc_gcn_torch.ops.kernels import PLAIN
from kgc_gcn_torch.ops.segment_max import segment_max, segment_max_reference
from kgc_gcn_torch.ops.segment_sum import segment_sum, segment_sum_reference

# Exact: the messages are multiples of 2**-8 below 2 in magnitude (also after
# rounding to bf16), so every partial sum of a row is exact in float32 and
# any summation order gives the same bits.  A dropped, doubled or misplaced
# edge, or a sum kept in bf16, changes the result.
ATOL = RTOL = 0.0


def csr_case(counts, d: int, seed: int):
    """(msg (E, d) float32, dst (E,) int32, indptr (n_rows+1,) int32) with
    the given per-row edge counts (zeros allowed), as numpy arrays."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts)
    dst = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    indptr = np.zeros(len(counts) + 1, np.int32)
    indptr[1:] = np.cumsum(counts)
    msg = (rng.integers(-511, 512, size=(len(dst), d)) / 256).astype(np.float32)
    return msg, dst, indptr


def case_counts():
    """Per-row edge counts and D: empty first/inner/last rows, D=37, a row
    count that is no multiple of 8; a hub row; D > 256 (two column chunks);
    one row holding every edge (the relation order's extreme); no edges at
    all; rows of 16, 32, 64 and 128 edges and one more or fewer, so that
    rows start and end on the kernel's chunk boundaries; D 1 and D 4 (lane
    groups narrower than a warp) with a hub row; Zipf in-degrees."""
    rng = np.random.default_rng(0)
    empty = rng.integers(0, 4, size=50)
    empty[[0, 7, 8, 49]] = 0
    hub = rng.integers(0, 3, size=19)
    hub[11] = 700
    wide = rng.integers(0, 5, size=9)                  # D > 256: two column chunks
    bounds = np.array([16, 15, 17, 32, 31, 33, 0, 64, 63, 65, 1, 128, 127,
                       129, 0, 48, 96, 32, 33, 31])
    narrow = rng.integers(0, 4, size=45)
    narrow[[3, 30]] = (500, 97)
    ranks = rng.permutation(300) + 1                   # in-degree ~ rank**-1.1
    zipf = np.bincount(rng.choice(300, size=3000, p=ranks**-1.1
                                  / (ranks**-1.1).sum()), minlength=300)
    return {"empty_rows": (empty, 37), "hub_row": (hub, 100),
            "wide": (wide, 300), "single_row": (np.array([3000]), 100),
            "no_edges": (np.zeros(10, np.int64), 8),
            "chunk_bounds": (bounds, 20), "hub_d1": (narrow, 1),
            "hub_d4": (narrow, 4), "zipf": (zipf, 16)}


def max_case(counts, h: int, seed: int):
    """K5's operands (logits (E, H) float32, dst (E,) int32, indptr) with the
    given per-row edge counts: normal logits, about a fifth of the edges at
    -inf (the masked padding edges of the RGAT softmax), and the first
    non-empty row all -inf."""
    rng = np.random.default_rng(seed)
    _, dst, indptr = csr_case(counts, 1, seed)
    logits = rng.normal(size=(len(dst), h)).astype(np.float32)
    logits[rng.random(len(dst)) < 0.2] = -np.inf
    first = int(np.flatnonzero(np.asarray(counts))[0])
    logits[indptr[first]:indptr[first + 1]] = -np.inf
    return logits, dst, indptr


def max_cases():
    """K5 edge cases, (per-row counts, H): empty rows, a 700-edge hub row,
    and head counts 1, 4, 5 and 40 (above one register chunk of heads)."""
    counts = case_counts()
    return {"empty_rows": (counts["empty_rows"][0], 4),
            "hub_h1": (counts["hub_row"][0], 1),
            "hub_h5": (counts["hub_row"][0], 5),
            "wide_h40": (counts["wide"][0], 40)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(case_counts()))
def test_segment_sum_kernel_matches_plain(cuda, case, dtype):
    counts, d = case_counts()[case]
    msg, dst, indptr = csr_case(counts, d, seed=3)
    m = torch.from_numpy(msg).to(getattr(torch, dtype)).to(cuda)
    dd, ip = torch.from_numpy(dst).to(cuda), torch.from_numpy(indptr).to(cuda)
    before = segment_sum.launches
    got = segment_sum(m, dd, ip, len(counts))
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (len(counts), d)
    want = segment_sum_reference(m, dd, ip, len(counts))
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hub_row", "zipf", "single_row"])
def test_segment_sum_kernel_is_deterministic(cuda, case):
    """Normal (non-dyadic) values, whose float32 sums depend on their order:
    two calls give the same bits (each row's order is fixed), within the
    error bound of float32 summation in any order of the float64 sums,
    g / (1 - g) * sum |msg| with g = (n - 1) * 2**-24 for a row of n edges."""
    counts, d = case_counts()[case]
    _, dst, indptr = csr_case(counts, d, seed=4)
    msg = np.random.default_rng(4).normal(size=(len(dst), d)).astype(np.float32)
    m = torch.from_numpy(msg).to(cuda)
    dd, ip = torch.from_numpy(dst).to(cuda), torch.from_numpy(indptr).to(cuda)
    first = segment_sum(m, dd, ip, len(counts))
    second = segment_sum(m, dd, ip, len(counts))
    assert torch.equal(first, second)
    exact = np.zeros((len(counts), d))
    np.add.at(exact, dst, msg.astype(np.float64))
    mass = np.zeros((len(counts), d))
    np.add.at(mass, dst, np.abs(msg.astype(np.float64)))
    g = np.maximum(np.asarray(counts) - 1, 0)[:, None] * 2.0**-24
    limit = g / (1 - g) * mass
    assert (np.abs(first.cpu().numpy() - exact) <= limit).all()


@pytest.mark.cuda
def test_encode_through_kernel_matches_plain_and_cpu(cuda):
    from kgc_gcn_torch.config import dataset_preset
    from kgc_gcn_torch.data.dataset import build_dataset
    from kgc_gcn_torch.data.graph import build_graph
    from kgc_gcn_torch.data.toy import toy_triples
    from kgc_gcn_torch.models import build_model

    ds = build_dataset("toy", *toy_triples(n_ent=40, n_rel=5, n_train=300))
    graph = build_graph(ds.train_triples, ds.num_entity, ds.num_relation)
    cfg = dataset_preset("Toy", gcn_in_dim=16, gcn_out_dim=32, k_w=4, k_h=8,
                         num_filter=4, kernel_size=3)
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=graph.e_pad).eval()
    with torch.no_grad():
        cpu_ent, cpu_rel = model.encode(graph)
        model, graph = model.to(cuda), graph.to(cuda)
        before = segment_sum.launches
        ent, rel = model.encode(graph)
        assert segment_sum.launches == before + 2
        ref_ent, _ = model.encode(graph, kernels=PLAIN)
    # real messages: float32 sums in another order, through BN and tanh
    tol = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ent, ref_ent, **tol)
    torch.testing.assert_close(ent.cpu(), cpu_ent, **tol)
    torch.testing.assert_close(rel.cpu(), cpu_rel, **tol)


# K2a: a float32 sum of B*N terms in another order; K2b: sums over B or N in
# another order, whose error scales with the summands (absolute part relative
# to the largest element)
K2_LOSS_RTOL = 1e-5
K2_GRAD_RTOL = K2_GRAD_ATOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,masked", [
    (128, 4099, 200, ()), (5, 1001, 37, (1, 3)), (7, 300, 300, (6,)),
    (70, 33, 64, (0, 69))])
def test_k2_kernels_match_plain(cuda, b, n, d, masked):
    gen = torch.Generator().manual_seed(b + n)
    h = torch.relu(torch.randn(b, d, generator=gen)).to(cuda)
    ent = torch.tanh(torch.randn(n, d, generator=gen)).to(cuda)
    bias = (torch.randn(n, generator=gen) * 0.1).to(cuda)
    w = torch.ones(b)
    w[list(masked)] = 0.0
    w = w.to(cuda)
    base, g = 1.0 / n, torch.tensor(1.0 / (b * n), device=cuda)
    before = (dense_loss.launches, dense_grads.launches)
    got = dense_loss(h, ent, bias, w, base)
    got_g = dense_grads(g, h, ent, bias, w, base)
    torch.cuda.synchronize()
    assert (dense_loss.launches, dense_grads.launches) == (before[0] + 1,
                                                           before[1] + 1)
    torch.testing.assert_close(got, dense_loss_reference(h, ent, bias, w, base),
                               rtol=K2_LOSS_RTOL, atol=0.0)
    for a, want in zip(got_g, dense_grads_reference(g, h, ent, bias, w, base)):
        torch.testing.assert_close(
            a, want, rtol=K2_GRAD_RTOL,
            atol=K2_GRAD_ATOL * float(want.abs().max()))
    for i in masked:
        assert float(got_g[0][i].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("loss_impl", ["fused", "sparse"])
def test_kernel_train_step_matches_plain_step(cuda, loss_impl):
    """One training step with dropout on the card through the kernels, and
    the same step (same weights, same dropout masks) through the plain
    versions: loss, gradients and updated parameters."""
    import copy

    from kgc_gcn_torch.config import dataset_preset
    from kgc_gcn_torch.convert import jax_leaf_names
    from kgc_gcn_torch.data.batching import make_banks
    from kgc_gcn_torch.data.dataset import build_dataset
    from kgc_gcn_torch.data.graph import build_graph
    from kgc_gcn_torch.data.toy import toy_triples
    from kgc_gcn_torch.models import build_model
    from kgc_gcn_torch.train import optim
    from kgc_gcn_torch.train.loop import Trainer

    ds = build_dataset("toy", *toy_triples(n_ent=40, n_rel=5, n_train=300))
    graph = build_graph(ds.train_triples, ds.num_entity,
                        ds.num_relation).to(cuda)
    banks = make_banks(ds, cuda)
    cfg = dataset_preset("Toy", gcn_in_dim=16, gcn_out_dim=32, k_w=4, k_h=8,
                         num_filter=4, kernel_size=3, batch_size=16,
                         loss_impl=loss_impl, gcn_drop=0.2, feat_drop=0.2,
                         hidden_drop=0.3, seed=5)
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=graph.e_pad).to(cuda)
    kernel = Trainer(cfg, model, graph, banks)
    plain = Trainer(cfg, copy.deepcopy(model), graph, banks, plain=True)
    bank = banks["train"]
    idx = torch.arange(16, device=cuda)
    batch = (bank.queries[idx], bank.label_idx[idx], torch.ones(16, device=cuda))
    before = [p.detach().clone() for p in kernel.params]
    out = {}
    for name, t in (("kernel", kernel), ("plain", plain)):
        launches = (segment_sum.launches, dense_loss.launches)
        loss = t.loss(*batch)
        grads = torch.autograd.grad(loss, t.params)
        optim.step(t.params, list(grads), t.opt_state, cfg, 1e-3)
        out[name] = (loss.detach(), grads, (segment_sum.launches - launches[0],
                                            dense_loss.launches - launches[1]))
    assert out["kernel"][2] == (4, int(loss_impl == "fused"))
    assert out["plain"][2] == (0, 0)
    # float32 sums in another order through one forward and backward pass
    torch.testing.assert_close(out["kernel"][0], out["plain"][0], rtol=1e-5,
                               atol=0.0)
    for i, name in enumerate(jax_leaf_names(cfg)[0]):
        if name in ("decoder.bn0.scale", "decoder.bn0.bias"):
            continue   # BN1 cancels them: float noise on both sides
        gk, gp = out["kernel"][1][i], out["plain"][1][i]
        torch.testing.assert_close(gk, gp, rtol=1e-3,
                                   atol=1e-4 * float(gp.abs().max()), msg=name)
        uk = kernel.params[i].detach() - before[i]
        up = plain.params[i].detach() - before[i]
        # first Adam step: each element moves by lr * sign(g) unless g ~ 0
        agree = torch.isclose(uk, up, rtol=1e-3, atol=1e-7)
        assert float(agree.float().mean()) > 0.999, name


# K7 / K8: edge cases (empty rows, a hub row, B = 1, d not a multiple of 32,
# K7 columns over two blocks (wide_d), K8 above 48 KB of shared memory
# (wide_d, layer2), and B > 32, where K8's d_a tasks of a full edge chunk
# fill every warp before the d_msg tiles (many_bases).  Inputs
# are multiples of 2**-4 below 1: every product and partial sum is exact in
# float32, so kernel and plain version agree to the bit.
BASIS_CASES = {
    "empty_rows": ("empty", 37, 3), "hub_row": ("hub", 100, 30),
    "one_basis": ("empty", 45, 1), "wide_d": ("wide", 600, 12),
    "layer2": ("hub", 200, 30), "many_bases": ("hub", 40, 70)}


def basis_case(name: str, seed: int):
    kind, d, nb = BASIS_CASES[name]
    counts = {"empty": case_counts()["empty_rows"][0],
              "hub": case_counts()["hub_row"][0],
              "wide": case_counts()["wide"][0]}[kind]
    rng = np.random.default_rng(seed)
    dyadic = lambda *s: (rng.integers(-15, 16, size=s) / 16).astype(np.float32)
    _, dst, indptr = csr_case(counts, 1, seed)
    e = len(dst)
    return (dyadic(e, d), dyadic(e, nb), dst, indptr,
            dyadic(len(counts), nb * d))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BASIS_CASES))
def test_basis_kernels_match_plain(cuda, case):
    msg, a, dst, indptr, g = (torch.from_numpy(x).to(cuda)
                              for x in basis_case(case, 5))
    n_rows = indptr.shape[0] - 1
    before = (basis_segment_sum.launches, basis_backward.launches)
    got = basis_segment_sum(msg, a, dst, indptr, n_rows)
    got_dm, got_da = basis_backward(g, msg, a, dst, indptr)
    torch.cuda.synchronize()
    assert (basis_segment_sum.launches, basis_backward.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(
        got, basis_segment_sum_reference(msg, a, dst, indptr, n_rows),
        rtol=0.0, atol=0.0)
    want_dm, want_da = basis_backward_reference(g, msg, a, dst, indptr)
    torch.testing.assert_close(got_dm, want_dm, rtol=0.0, atol=0.0)
    torch.testing.assert_close(got_da, want_da, rtol=0.0, atol=0.0)


@pytest.mark.cuda
def test_basis_backward_refuses_a_row_beyond_its_shared_memory(cuda):
    d, nb = 100, BASIS_BWD_MAX_SMEM // 400 + 1     # B*d*4 bytes > the limit
    msg = torch.zeros(3, d, device=cuda)
    a = torch.zeros(3, nb, device=cuda)
    dst = torch.tensor([0, 0, 1], dtype=torch.int32, device=cuda)
    indptr = torch.tensor([0, 2, 3], dtype=torch.int32, device=cuda)
    g = torch.zeros(2, nb * d, device=cuda)
    before = basis_backward.launches
    with pytest.raises(ValueError, match="shared memory"):
        basis_backward(g, msg, a, dst, indptr)
    assert basis_backward.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("neg_loss", ["bce", "self_adversarial"])
def test_rgcn_kernel_step_matches_plain_step(cuda, neg_loss):
    """One R-GCN + DistMult negative-sampling step with dropout through
    K7/K8/K1, and the same step (same weights, negatives and dropout masks)
    through the plain versions: loss, gradients and updates."""
    import copy

    from kgc_gcn_torch.config import dataset_preset
    from kgc_gcn_torch.data.batching import make_banks
    from kgc_gcn_torch.data.dataset import build_dataset
    from kgc_gcn_torch.data.graph import build_graph
    from kgc_gcn_torch.data.toy import toy_triples
    from kgc_gcn_torch.models import build_model
    from kgc_gcn_torch.train import optim
    from kgc_gcn_torch.train.negative import NegativeSamplingTrainer

    ds = build_dataset("toy", *toy_triples(n_ent=40, n_rel=5, n_train=300))
    graph = build_graph(ds.train_triples, ds.num_entity,
                        ds.num_relation).to(cuda)
    banks = make_banks(ds, cuda)
    cfg = dataset_preset("Toy", model="rgcn", decoder="distmult", num_bases=4,
                         num_layers=2, gcn_in_dim=16, gcn_out_dim=32,
                         batch_size=16, num_negatives=8, gcn_drop=0.2,
                         train_mode="negative_sampling", neg_loss=neg_loss,
                         seed=5)
    model = build_model(cfg, ds.num_entity, ds.num_relation,
                        ds.num_edge).to(cuda)
    kernel = NegativeSamplingTrainer(cfg, model, graph, banks)
    plain = NegativeSamplingTrainer(cfg, copy.deepcopy(model), graph, banks,
                                    plain=True)
    idx = torch.arange(16, device=cuda)
    batch = kernel.batch(idx, torch.ones(16, device=cuda))
    before = [p.detach().clone() for p in kernel.params]
    out = {}
    for name, t in (("kernel", kernel), ("plain", plain)):
        t.generator.manual_seed(9)
        launches = (basis_segment_sum.launches, basis_backward.launches,
                    segment_sum.launches)
        loss = t.loss(*batch)
        grads = torch.autograd.grad(loss, t.params)
        optim.step(t.params, list(grads), t.opt_state, cfg, 1e-3)
        out[name] = (loss.detach(), grads, (
            basis_segment_sum.launches - launches[0],
            basis_backward.launches - launches[1],
            segment_sum.launches - launches[2]))
    assert out["kernel"][2] == (4, 4, 4)      # two layers x two halves
    assert out["plain"][2] == (0, 0, 0)
    # float32 sums in another order through one forward and backward pass
    torch.testing.assert_close(out["kernel"][0], out["plain"][0], rtol=1e-5,
                               atol=0.0)
    for i, (gk, gp) in enumerate(zip(out["kernel"][1], out["plain"][1])):
        torch.testing.assert_close(gk, gp, rtol=1e-4,
                                   atol=1e-4 * float(gp.abs().max()))
        uk = kernel.params[i].detach() - before[i]
        up = plain.params[i].detach() - before[i]
        agree = torch.isclose(uk, up, rtol=1e-3, atol=1e-7)
        assert float(agree.float().mean()) > 0.999


def path_max_case(seed: int):
    """K5 at the RGAT path's shape: WN18RR's 40,943 rows, 86,835 real edges
    with random destinations and the 205 zero-norm padding edges of E_pad
    87,040 in row N-1, their logits at -inf; H 4."""
    rng = np.random.default_rng(seed)
    n, e_real, e_pad = 40943, 86835, 87040
    dst = np.concatenate([np.sort(rng.integers(0, n, e_real)),
                          np.full(e_pad - e_real, n - 1)]).astype(np.int32)
    indptr = np.searchsorted(dst, np.arange(n + 1)).astype(np.int32)
    logits = rng.normal(size=(e_pad, 4)).astype(np.float32)
    logits[e_real:] = -np.inf
    return logits, dst, indptr


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["path", "nan"] + sorted(max_cases()))
def test_segment_max_kernel_matches_plain(cuda, case):
    """K5 equals its plain version bit for bit (a max is exact in any
    order; -0.0 and +0.0 count as equal), NaN included: a NaN logit wins
    its row and head, as in the plain "amax" reduction."""
    if case == "path":
        logits, dst, indptr = path_max_case(7)
    else:
        counts, h = max_cases()["hub_h5" if case == "nan" else case]
        logits, dst, indptr = max_case(counts, h, seed=7)
        if case == "nan":
            logits[[3, 40, 41], [0, 2, 4]] = np.nan
    n_rows = len(indptr) - 1
    lg, dd, ip = (torch.from_numpy(a).to(cuda) for a in (logits, dst, indptr))
    before = segment_max.launches
    got = segment_max(lg, dd, ip, n_rows)
    torch.cuda.synchronize()
    assert segment_max.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (n_rows, lg.shape[1])
    want = segment_max_reference(lg, dd, ip, n_rows)
    torch.testing.assert_close(got, want, rtol=0.0, atol=0.0,
                               equal_nan=case == "nan")
    if case == "nan":
        assert int(torch.isnan(got).sum()) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("name,k1_launches", [
    ("edge_compose", 1), ("segment_sum_sorted", 1), ("gather_rows_sorted", 1),
    ("gather_rows_few", 0)])
def test_k6_through_k1_matches_plain(cuda, name, k1_launches):
    """Each attention wrapper's forward and gradients with K1 against the
    same with the plain segment-sum, on the card.  Dyadic inputs and
    cotangents (multiples of 2**-8 below 1): every product and partial sum
    is exact in float32, so the two agree to the bit."""
    from kgc_gcn_torch.data.dataset import build_dataset
    from kgc_gcn_torch.data.graph import build_graph
    from kgc_gcn_torch.data.toy import toy_triples
    from kgc_gcn_torch.ops import sorted_ops

    ds = build_dataset("toy", *toy_triples(n_ent=40, n_rel=5, n_train=300))
    half = build_graph(ds.train_triples, ds.num_entity,
                       ds.num_relation).to(cuda).outb
    n, n_rel2 = ds.num_entity, 2 * ds.num_relation
    n_seg = half.r_indptr.shape[0] - 1
    rdata = (half.rperm, half.r_indptr, half.r_rel)
    rng = np.random.default_rng(11)
    dyadic = lambda *s: torch.from_numpy(
        (rng.integers(-255, 256, size=s) / 256).astype(np.float32)).to(cuda)
    calls = {
        "edge_compose": (lambda s, h, r: sorted_ops.edge_compose(h, r, half, s),
                         (dyadic(n, 32), dyadic(n_rel2, 32))),
        "segment_sum_sorted": (lambda s, v: sorted_ops.segment_sum_sorted(
            v, half.dst, half.indptr, n, s), (dyadic(half.dst.shape[0], 4),)),
        "gather_rows_sorted": (lambda s, t: sorted_ops.gather_rows_sorted(
            t, half.dst, half.indptr, n, s), (dyadic(n, 4),)),
        "gather_rows_few": (lambda s, t: sorted_ops.gather_rows_few(
            t, half.rel, n_seg, rdata, s), (dyadic(n_rel2, 4),)),
    }
    fn, inputs = calls[name]
    with torch.no_grad():
        g = dyadic(*fn(PLAIN.seg_sum, *inputs).shape)
    out = {}
    for which, seg_sum in (("kernel", segment_sum), ("plain", PLAIN.seg_sum)):
        args = [a.clone().requires_grad_() for a in inputs]
        before = segment_sum.launches
        y = fn(seg_sum, *args)
        y.backward(g)
        torch.cuda.synchronize()
        out[which] = (y.detach(), [a.grad for a in args],
                      segment_sum.launches - before)
    assert out["kernel"][2] == k1_launches and out["plain"][2] == 0
    torch.testing.assert_close(out["kernel"][0], out["plain"][0], rtol=0,
                               atol=0)
    for got, want in zip(out["kernel"][1], out["plain"][1]):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_rgat_kernel_step_matches_plain_step(cuda):
    """One 2-layer, 4-head RGAT + DistMult 1-vs-all step with dropout
    through K5/K1, and the same step (same weights and dropout masks)
    through the plain versions: loss, gradients and updates."""
    import copy

    from kgc_gcn_torch.config import dataset_preset
    from kgc_gcn_torch.data.batching import make_banks
    from kgc_gcn_torch.data.dataset import build_dataset
    from kgc_gcn_torch.data.graph import build_graph
    from kgc_gcn_torch.data.toy import toy_triples
    from kgc_gcn_torch.models import build_model
    from kgc_gcn_torch.train import optim
    from kgc_gcn_torch.train.loop import Trainer

    ds = build_dataset("toy", *toy_triples(n_ent=40, n_rel=5, n_train=300))
    graph = build_graph(ds.train_triples, ds.num_entity,
                        ds.num_relation).to(cuda)
    banks = make_banks(ds, cuda)
    cfg = dataset_preset("Toy", model="rgat", decoder="distmult", num_heads=4,
                         num_layers=2, gcn_in_dim=16, gcn_out_dim=32,
                         batch_size=16, gcn_drop=0.2, seed=5)
    model = build_model(cfg, ds.num_entity, ds.num_relation,
                        ds.num_edge).to(cuda)
    with torch.no_grad():        # the attention bias starts at zero
        for layer in model.layers:
            layer.rel_bias.normal_(0.0, 0.5)
    kernel = Trainer(cfg, model, graph, banks)
    plain = Trainer(cfg, copy.deepcopy(model), graph, banks, plain=True)
    bank = banks["train"]
    idx = torch.arange(16, device=cuda)
    batch = (bank.queries[idx], bank.label_idx[idx], torch.ones(16, device=cuda))
    before = [p.detach().clone() for p in kernel.params]
    out = {}
    for name, t in (("kernel", kernel), ("plain", plain)):
        t.generator.manual_seed(9)
        launches = (segment_max.launches, segment_sum.launches)
        loss = t.loss(*batch)
        grads = torch.autograd.grad(loss, t.params)
        optim.step(t.params, list(grads), t.opt_state, cfg, 1e-3)
        out[name] = (loss.detach(), grads, (segment_max.launches - launches[0],
                                            segment_sum.launches - launches[1]))
    assert out["kernel"][2] == (4, 20)      # two layers x two halves
    assert out["plain"][2] == (0, 0)
    # float32 sums in another order through one forward and backward pass
    torch.testing.assert_close(out["kernel"][0], out["plain"][0], rtol=1e-5,
                               atol=0.0)
    for i, (gk, gp) in enumerate(zip(out["kernel"][1], out["plain"][1])):
        assert torch.isfinite(gk).all()
        torch.testing.assert_close(gk, gp, rtol=1e-4,
                                   atol=1e-4 * float(gp.abs().max()))
        uk = kernel.params[i].detach() - before[i]
        up = plain.params[i].detach() - before[i]
        agree = torch.isclose(uk, up, rtol=1e-3, atol=1e-7)
        assert float(agree.float().mean()) > 0.999


# K4a / K4b: elementwise products in the plain version's order, each rounded
# once, so kernel and plain version agree to the bit on any input.  Cases:
# the path's shape (a multiple of 4 elements, float4 path), a tail of
# (E*d) % 4 elements, and views at a row offset that are not 16-byte aligned
# (the scalar path).
EW_CASES = {"path": (4096, 100, 0), "tail": (1001, 37, 0),
            "misaligned": (1001, 37, 1), "misaligned_d100": (257, 100, 3)}


def ew_operands(n: int, case: str, cuda):
    e, d, offset = EW_CASES[case]
    gen = torch.Generator().manual_seed(e + d)
    return [torch.randn(e + offset, d, generator=gen).to(cuda)[offset:]
            for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(EW_CASES))
def test_elementwise_kernels_match_plain(cuda, case, out_dtype):
    from kgc_gcn_torch.ops.elementwise import (
        bwd_products, bwd_products_reference, compose_msg,
        compose_msg_reference)
    dt = getattr(torch, out_dtype)
    xgn, rg, etab = ew_operands(3, case, cuda)
    gdn, xg = ew_operands(2, case, cuda)
    before = (compose_msg.launches, bwd_products.launches)
    got = compose_msg(xgn, rg, etab, dt)
    got_b = bwd_products(gdn, xg, rg, etab, dt)
    torch.cuda.synchronize()
    assert (compose_msg.launches, bwd_products.launches) == (before[0] + 1,
                                                             before[1] + 1)
    assert got.dtype == dt and got.shape == xgn.shape
    torch.testing.assert_close(got, compose_msg_reference(xgn, rg, etab, dt),
                               rtol=0, atol=0)
    want_b = bwd_products_reference(gdn, xg, rg, etab, dt)
    assert [t.dtype for t in got_b] == [dt, dt, torch.float32]
    for a, b in zip(got_b, want_b):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def stacked_case(counts, d: int, seed: int, real: bool):
    """K3's operands on the card over CSR rows with the given edge counts:
    x (40, d), rel_all (7, d), etab (E, d), norm (E,), random src and rel;
    multiples of 2**-3 below 1 (every product and partial sum exact in
    float32), or normal values with ``real``."""
    rng = np.random.default_rng(seed)
    _, dst, indptr = csr_case(counts, 1, seed)
    e = len(dst)
    draw = ((lambda *s: rng.normal(size=s)) if real else
            (lambda *s: rng.integers(-7, 8, size=s) / 8))
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    return [t.to("cuda") for t in (
        f32(draw(40, d)), i32(rng.integers(0, 40, e)), f32(draw(e)),
        f32(draw(7, d)), i32(rng.integers(0, 7, e)), f32(draw(e, d)),
        i32(dst), i32(indptr))] + [len(counts)]


@pytest.mark.cuda
@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("case", sorted(case_counts()))
def test_fused_compose_kernel_matches_plain(cuda, case, real):
    """K3 against its plain version: bit-equal on dyadic inputs; on normal
    values float32 sums in another order (rtol 1e-5, atol 1e-5 x max)."""
    from kgc_gcn_torch.ops.fused_compose import (
        fused_compose, fused_compose_reference)
    counts, d = case_counts()[case]
    args = stacked_case(counts, d, seed=2, real=real)
    before = fused_compose.launches
    got = fused_compose(*args)
    torch.cuda.synchronize()
    assert fused_compose.launches == before + 1
    want = fused_compose_reference(*args)
    tol = 1e-5 if real else 0.0
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("schedule,per_step", [
    ("stacked", dict(K1=1, K3=1)), ("stacked_xla", dict(K1=2)),
    ("ew_pallas", dict(K1=4, K4a=2, K4b=2))])
def test_mgcn_schedule_kernel_step_matches_plain_step(cuda, schedule,
                                                      per_step):
    """One MGCN 1-vs-all step with dropout under one aggregation schedule,
    through the kernels and through the plain versions (same weights and
    dropout masks): launches, loss, gradients and updates."""
    import copy

    from kgc_gcn_torch.config import dataset_preset
    from kgc_gcn_torch.convert import jax_leaf_names
    from kgc_gcn_torch.data.batching import make_banks
    from kgc_gcn_torch.data.dataset import build_dataset
    from kgc_gcn_torch.data.graph import build_graph
    from kgc_gcn_torch.data.toy import toy_triples
    from kgc_gcn_torch.models import build_model
    from kgc_gcn_torch.ops.elementwise import bwd_products, compose_msg
    from kgc_gcn_torch.ops.fused_compose import fused_compose
    from kgc_gcn_torch.train import optim
    from kgc_gcn_torch.train.loop import Trainer

    field = ({"ew_impl": "pallas"} if schedule == "ew_pallas"
             else {"spmm_mode": schedule})
    counters = {"K1": segment_sum, "K3": fused_compose, "K4a": compose_msg,
                "K4b": bwd_products}
    ds = build_dataset("toy", *toy_triples(n_ent=40, n_rel=5, n_train=300))
    graph = build_graph(ds.train_triples, ds.num_entity,
                        ds.num_relation).to(cuda)
    banks = make_banks(ds, cuda)
    cfg = dataset_preset("Toy", gcn_in_dim=16, gcn_out_dim=32, k_w=4, k_h=8,
                         num_filter=4, kernel_size=3, batch_size=16,
                         gcn_drop=0.2, feat_drop=0.2, hidden_drop=0.3, seed=5,
                         **field)
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=graph.e_pad).to(cuda)
    kernel = Trainer(cfg, model, graph, banks)
    plain = Trainer(cfg, copy.deepcopy(model), graph, banks, plain=True)
    bank = banks["train"]
    idx = torch.arange(16, device=cuda)
    batch = (bank.queries[idx], bank.label_idx[idx], torch.ones(16, device=cuda))
    before = [p.detach().clone() for p in kernel.params]
    out = {}
    for name, t in (("kernel", kernel), ("plain", plain)):
        t.generator.manual_seed(9)
        start = {k: f.launches for k, f in counters.items()}
        loss = t.loss(*batch)
        grads = torch.autograd.grad(loss, t.params)
        optim.step(t.params, list(grads), t.opt_state, cfg, 1e-3)
        out[name] = (loss.detach(), grads, {
            k: f.launches - start[k] for k, f in counters.items()})
    assert out["kernel"][2] == {k: per_step.get(k, 0) for k in counters}
    assert not any(out["plain"][2].values())
    # float32 sums in another order through one forward and backward pass
    torch.testing.assert_close(out["kernel"][0], out["plain"][0], rtol=1e-5,
                               atol=0.0)
    for i, name in enumerate(jax_leaf_names(cfg)[0]):
        if name in ("decoder.bn0.scale", "decoder.bn0.bias"):
            continue   # BN1 cancels them: float noise on both sides
        gk, gp = out["kernel"][1][i], out["plain"][1][i]
        torch.testing.assert_close(gk, gp, rtol=1e-3,
                                   atol=1e-4 * float(gp.abs().max()), msg=name)
        uk = kernel.params[i].detach() - before[i]
        up = plain.params[i].detach() - before[i]
        agree = torch.isclose(uk, up, rtol=1e-3, atol=1e-7)
        assert float(agree.float().mean()) > 0.999, name
