"""Tests of the port that need an NVIDIA card: each CUDA kernel against its
plain PyTorch version on the card, the encoder through the kernels, the
RGAT attention wrappers' gradients through K1, and one training step through
the kernels against the same step in plain PyTorch (MGCN 1-vs-all, also
under each aggregation schedule, at 2 layers with corr and with ComplEx on
the fused loss; R-GCN on sampled negatives, also with RotatE; RGAT
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
    BASIS_SUM_PIECE, basis_backward, basis_backward_reference,
    basis_bwd_window, basis_segment_sum, basis_segment_sum_reference)
from kgc_gcn_torch.ops.fused_loss import (
    dense_grads, dense_grads_reference, dense_loss, dense_loss_reference,
    grads_schedule, loss_schedule)
from kgc_gcn_torch.ops.kernels import PLAIN
from kgc_gcn_torch.ops.segment_max import (
    SEGMENT_MAX_CHUNK, SEGMENT_MAX_LIMIT, arrival_counters, segment_max,
    segment_max_reference)
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


def _on_card_at(t: torch.Tensor, offset: int, cuda) -> torch.Tensor:
    """``t`` copied to the card as a contiguous view ``offset`` floats into
    its buffer (the allocator's buffers start 16-byte aligned)."""
    buf = torch.empty(t.numel() + offset, device=cuda)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def k2_match_plain(cuda, b, n, d, masked, offset=0):
    """K2a and K2b on the card against their plain versions, one launch
    each, masked rows with a zero d_h; h and ent start ``offset`` floats
    into their buffers."""
    gen = torch.Generator().manual_seed(b + n)
    h = _on_card_at(torch.relu(torch.randn(b, d, generator=gen)), offset, cuda)
    ent = _on_card_at(torch.tanh(torch.randn(n, d, generator=gen)), offset,
                      cuda)
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
@pytest.mark.parametrize("b,n,d,masked", [
    (128, 4099, 200, ()), (5, 1001, 37, (1, 3)), (7, 300, 300, (6,)),
    (70, 33, 64, (0, 69)),
    # K2b's edges: B above one row chunk of 128 (and with two windows), N
    # below one tile of 64, N one past a tile multiple, d 1, runs of two
    # tiles a block with a ragged last tile
    (300, 129, 40, (0, 150, 299)), (130, 200, 300, (0, 129)),
    (9, 50, 64, (4,)), (3, 65, 1, (1,)), (64, 19201, 200, (5,)),
    # K2a's edges: d 203 (two windows of 104, 4-byte copies), d 496 (three
    # windows of 168)
    (128, 700, 203, (3,)), (9, 50, 496, (4,))])
def test_k2_kernels_match_plain(cuda, b, n, d, masked):
    k2_match_plain(cuda, b, n, d, masked)


@pytest.mark.cuda
def test_k2_kernels_take_misaligned_views(cuda):
    """h and ent as views one float past a 16-byte boundary: both kernels
    take their 4-byte copies."""
    k2_match_plain(cuda, 70, 333, 200, (2,), offset=1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", [(128, 19201, 200), (130, 700, 300)])
def test_k2b_is_deterministic(cuda, b, n, d):
    """d_h is added over the blocks' partials in a fixed order and d_ent,
    d_bias have one writer each: two calls on normal values, whose float32
    sums depend on their order, give the same bits."""
    gen = torch.Generator().manual_seed(b * n)
    h, ent = (torch.randn(b, d, generator=gen).to(cuda),
              torch.randn(n, d, generator=gen).to(cuda))
    bias = torch.randn(n, generator=gen).to(cuda)
    w = torch.ones(b, device=cuda)
    g = torch.tensor(1.0 / (b * n), device=cuda)
    first = dense_grads(g, h, ent, bias, w, 1.0 / n)
    second = dense_grads(g, h, ent, bias, w, 1.0 / n)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))


@pytest.mark.cuda
def test_k2a_refuses_d0(cuda):
    """d 0 raises on the card, as the JAX kernel refuses it."""
    h, ent = torch.zeros(3, 0, device=cuda), torch.zeros(5, 0, device=cuda)
    with pytest.raises(ValueError, match="d >= 1"):
        dense_loss(h, ent, torch.zeros(5, device=cuda),
                   torch.ones(3, device=cuda), 0.2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", [(128, 19201, 200), (130, 700, 300)])
def test_k2a_is_deterministic(cuda, b, n, d):
    """Each block adds its terms in a fixed order and the partials are
    added in block order: two calls on normal values, whose float32 sums
    depend on their order, give the same bits."""
    gen = torch.Generator().manual_seed(b * n + 1)
    h, ent = (torch.randn(b, d, generator=gen).to(cuda),
              torch.randn(n, d, generator=gen).to(cuda))
    bias = torch.randn(n, generator=gen).to(cuda)
    w = torch.ones(b, device=cuda)
    first = dense_loss(h, ent, bias, w, 1.0 / n)
    second = dense_loss(h, ent, bias, w, 1.0 / n)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_k2a_schedule_matches_the_source(cuda):
    """loss_schedule's shared-memory size and partial count are the
    launcher's, for every d from 1 to 1,000."""
    from kgc_gcn_torch.utils.cuda_build import load_kernels
    lib = load_kernels().lib
    for d in range(1, 1001):
        sched = loss_schedule(128, 40943, d, 132)
        assert lib.kgc_fused_bce_loss_smem(sched.window) == sched.smem_bytes
        assert lib.kgc_fused_bce_loss_partials(
            128, 40943, sched.tiles_per_block) == sched.partials


@pytest.mark.cuda
def test_k2b_schedule_matches_the_source(cuda):
    """grads_schedule's shared-memory size is the launcher's, at every
    window it can choose."""
    from kgc_gcn_torch.utils.cuda_build import load_kernels
    lib = load_kernels().lib
    for d in range(1, 1000, 7):
        sched = grads_schedule(128, 1000, d, 132)
        assert lib.kgc_fused_bce_grads_smem(sched.window) == sched.smem_bytes


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
# (wide_d, layer2), and B > 32 (many_bases)); rows of 16, 32, 64 and 128
# edges and one more or fewer, so that K8's runs start and end at every
# offset of its 64-edge spans (span_bounds, also with d and B no multiples
# of 4: its 4-byte copies), and Zipf in-degrees, a hub across many spans
# (zipf_hub, also with B a multiple of 4: its 16-byte copies of a).  K7's
# heavy rows (more than BASIS_SUM_PIECE = T edges): one hub of several
# pieces at config 3's widths (one_hub), two heavy rows meeting inside one
# piece with 4-byte copies of msg (two_hubs, d 37), rows of exactly T and
# T + 1 edges at d 200 (t_plus_1), a heavy row starting on a piece boundary
# and a heavy last row that ends at E (piece_bounds).  Rows too wide for one
# K8 block's shared memory, which K8 takes in column windows: B 128 at
# d 256 (two windows of 128), d 601 (a narrower last window, 4-byte copies)
# and d 1500 (three windows).  Inputs are multiples of 2**-4 below 1: every
# product and partial sum is exact in float32, so kernel and plain version
# agree to the bit.
BASIS_CASES = {
    "empty_rows": ("empty", 37, 3), "hub_row": ("hub", 100, 30),
    "one_basis": ("empty", 45, 1), "wide_d": ("wide", 600, 12),
    "layer2": ("hub", 200, 30), "many_bases": ("hub", 40, 70),
    "span_bounds": ("bounds", 100, 30), "span_bounds_d37": ("bounds", 37, 5),
    "zipf_hub": ("zipf", 100, 30), "zipf_hub_b8": ("zipf", 64, 8),
    "one_hub": ("one_hub", 100, 30), "two_hubs": ("two_hubs", 37, 5),
    "t_plus_1": ("t_plus_1", 200, 30), "piece_bounds": ("piece_bounds", 64, 8),
    "windows_b128": ("hub", 256, 128), "windows_d601": ("bounds", 601, 64),
    "windows_d1500": ("zipf", 1500, 30)}


def heavy_counts():
    """Per-row edge counts with rows above K7's piece length T."""
    t = BASIS_SUM_PIECE
    rng = np.random.default_rng(1)
    one_hub = rng.integers(0, 4, size=40)
    one_hub[17] = 5 * t + 37
    return {"one_hub": one_hub,
            # rows 1 and 2 share the piece [2T, 3T)
            "two_hubs": np.array([100, 2 * t + 100, t + 150, 3, 0, 2]),
            "t_plus_1": np.array([5, t, t + 1, 0, t, t + 1, 1]),
            "piece_bounds": np.array([t, 2 * t + 90, 10, 0, t + 40])}


def basis_case(name: str, seed: int, real: bool = False):
    kind, d, nb = BASIS_CASES[name]
    counts = {"empty": case_counts()["empty_rows"][0],
              "hub": case_counts()["hub_row"][0],
              "wide": case_counts()["wide"][0],
              "bounds": case_counts()["chunk_bounds"][0],
              "zipf": case_counts()["zipf"][0], **heavy_counts()}[kind]
    rng = np.random.default_rng(seed)
    draw = ((lambda *s: rng.normal(size=s).astype(np.float32)) if real else
            (lambda *s: (rng.integers(-15, 16, size=s) / 16).astype(np.float32)))
    _, dst, indptr = csr_case(counts, 1, seed)
    e = len(dst)
    return (draw(e, d), draw(e, nb), dst, indptr, draw(len(counts), nb * d))


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
@pytest.mark.parametrize("case", ["zipf_hub", "span_bounds_d37",
                                  "windows_b128"])
def test_basis_backward_is_deterministic(cuda, case):
    """Normal values, whose float32 sums depend on their order: each
    output's order is fixed, so two calls give the same bits."""
    msg, a, dst, indptr, g = (torch.from_numpy(x).to(cuda)
                              for x in basis_case(case, 6, real=True))
    first = basis_backward(g, msg, a, dst, indptr)
    second = basis_backward(g, msg, a, dst, indptr)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_hub", "two_hubs"])
def test_basis_sum_is_deterministic(cuda, case):
    """Normal values on rows split into pieces: pass A sums a piece in edge
    order and pass B the partials in piece order, so two calls give the
    same bits."""
    msg, a, dst, indptr, _ = (torch.from_numpy(x).to(cuda)
                              for x in basis_case(case, 7, real=True))
    n_rows = indptr.shape[0] - 1
    first = basis_segment_sum(msg, a, dst, indptr, n_rows)
    second = basis_segment_sum(msg, a, dst, indptr, n_rows)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_basis_backward_takes_wide_rows_in_column_windows(cuda):
    """B 128 at d 256, which the JAX package's kernel trains: a whole row
    does not fit in one K8 block's shared memory, so K8 takes d in two
    windows of 128 columns; one launch, equal to the plain backward on
    normal values (float32 sums in another order).  Above B 436 no window
    fits and the card raises, with no launch."""
    d, nb = 256, 128
    assert basis_bwd_window(d, nb) == 128
    rng = np.random.default_rng(8)
    counts = rng.integers(0, 5, size=40)
    counts[9] = 150                        # a row over three spans
    _, dst, indptr = csr_case(counts, 1, 8)
    e = len(dst)
    msg, a, g = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 .to(cuda) for s in ((e, d), (e, nb), (len(counts), nb * d)))
    dst, indptr = (torch.from_numpy(x).to(cuda) for x in (dst, indptr))
    before = basis_backward.launches
    got = basis_backward(g, msg, a, dst, indptr)
    assert basis_backward.launches == before + 1
    for x, y in zip(got, basis_backward_reference(g, msg, a, dst, indptr)):
        torch.testing.assert_close(x, y, rtol=1e-5,
                                   atol=1e-5 * float(y.abs().max()))
    wide = torch.zeros(e, 437, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        basis_backward(torch.zeros(len(counts), 437 * 4, device=cuda),
                       msg[:, :4].contiguous(), wide, dst, indptr)
    assert basis_backward.launches == before + 1


@pytest.mark.cuda
def test_basis_aggregate_on_a_hub_graph_matches_plain(cuda):
    """The autograd function through K7 (with a row of several pieces), K8
    and K1 against the plain versions: the value, d_x and d_coeff of a
    weighted sum of the aggregate (float32 sums in another order)."""
    from kgc_gcn_torch.data.graph import build_graph
    from kgc_gcn_torch.ops.basis import basis_aggregate
    from kgc_gcn_torch.ops.kernels import KERNELS

    rng = np.random.default_rng(9)
    n_ent, n_rel, n_tri, nb, d = 60, 4, 2000, 6, 16
    tri = np.stack([rng.integers(n_ent, size=n_tri),
                    rng.integers(n_rel, size=n_tri),
                    rng.integers(n_ent, size=n_tri)], axis=1)
    tri[: 3 * BASIS_SUM_PIECE, 2] = 7          # entity 7: a row of 3T+ edges
    half = build_graph(tri, n_ent, n_rel).to(cuda).inb
    assert int((half.indptr[1:] - half.indptr[:-1]).max()) > 3 * BASIS_SUM_PIECE
    x = rng.normal(size=(n_ent, d)).astype(np.float32)
    coeff = rng.normal(size=(2 * n_rel, nb)).astype(np.float32)
    w = torch.from_numpy(rng.normal(size=(n_ent, nb * d)).astype(np.float32))
    out = {}
    for name, kernels in (("kernel", KERNELS), ("plain", PLAIN)):
        xt = torch.from_numpy(x).to(cuda).requires_grad_()
        ct = torch.from_numpy(coeff).to(cuda).requires_grad_()
        before = basis_segment_sum.launches
        agg = basis_aggregate(xt, ct, half, n_ent, kernels)
        (agg * w.to(cuda)).sum().backward()
        assert basis_segment_sum.launches == before + (name == "kernel")
        out[name] = (agg.detach(), xt.grad, ct.grad)
    for got, want in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.detach().abs().max()))


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


def k5_layouts():
    """Per-row counts where K5's rules are tight, at its own chunk C and
    limit L: rows of exactly C and C+1 edges and of L and L+1, a hub of many
    pieces, runs of empty rows across a chunk boundary, empty first and last
    rows; and the power-law in-degrees at FB15k-237's counts (272,115 edges
    over 14,541 rows, row ~ rank**-1.1, a row of tens of thousands)."""
    c, lim = SEGMENT_MAX_CHUNK, SEGMENT_MAX_LIMIT
    rng = np.random.default_rng(1)
    n_fb, e_fb = 14541, 272115
    rank_w = (rng.permutation(n_fb) + 1.0) ** -1.1
    power = np.bincount(rng.choice(n_fb, size=e_fb, p=rank_w / rank_w.sum()),
                        minlength=n_fb)
    return {"bounds": [0, c, c + 1, 0, 0, lim, lim + 1, 1, c - 1, 0, 2,
                       lim - 1, 0],
            "hub_pieces": [0, 3, 9 * c + 17, 1, 0, 0, 5, 4 * lim, 0],
            "empty_runs": [0] * 5 + [c - 3] + [0] * 40 + [7] + [0] * 9,
            "powerlaw": power}


def k5_on_card(counts, h: int, cuda, lead: int = 0, cut: int = 0,
               offset: int = 0, seed: int = 7):
    """K5's operands on the card with ``lead`` edges before indptr[0] and
    ``cut`` after indptr[-1] (rows 0 and N-1 in dst, in no row's range),
    logits ``offset`` floats into their buffer; and the plain version's
    result over the rows' edges."""
    logits, dst, indptr = max_case(counts, h, seed)
    n_rows = len(indptr) - 1
    rng = np.random.default_rng(seed + 1)
    logits = np.concatenate([rng.normal(size=(lead, h)), logits,
                             rng.normal(size=(cut, h))]).astype(np.float32)
    dst = np.concatenate([np.zeros(lead), dst,
                          np.full(cut, n_rows - 1)]).astype(np.int32)
    indptr = (indptr + lead).astype(np.int32)
    lg = _on_card_at(torch.from_numpy(logits), offset, cuda)
    dd, ip = torch.from_numpy(dst).to(cuda), torch.from_numpy(indptr).to(cuda)
    a, b = lead, lead + int(indptr[-1] - indptr[0])
    want = segment_max_reference(lg[a:b], dd[a:b], ip, n_rows)
    return lg, dd, ip, n_rows, want


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [1, 4, 5, 40])
@pytest.mark.parametrize("name", sorted(k5_layouts()))
def test_segment_max_kernel_on_tight_layouts(cuda, name, h):
    """K5 equals its plain version bit for bit on the layouts where its
    chunk, owner, limit and piece rules are tight, also with edges outside
    [indptr[0], indptr[-1]); one launch a call, two calls bit-identical."""
    counts = k5_layouts()[name]
    for lead, cut in ((0, 0), (SEGMENT_MAX_CHUNK + 3, 50)):
        lg, dd, ip, n_rows, want = k5_on_card(counts, h, cuda, lead, cut)
        before = segment_max.launches
        got = segment_max(lg, dd, ip, n_rows)
        torch.cuda.synchronize()
        assert segment_max.launches == before + 1
        torch.testing.assert_close(got, want, rtol=0.0, atol=0.0)
        assert torch.equal(bits(got), bits(segment_max(lg, dd, ip, n_rows)))


@pytest.mark.cuda
def test_segment_max_takes_a_misaligned_base(cuda):
    """Logits 4 bytes into their buffer (no float4 loads) at H 4 and H 40,
    on the hub layout: bit-equal to the plain version."""
    for h in (4, 40):
        lg, dd, ip, n_rows, want = k5_on_card(k5_layouts()["hub_pieces"], h,
                                              cuda, offset=1)
        assert lg.data_ptr() % 16
        torch.testing.assert_close(segment_max(lg, dd, ip, n_rows), want,
                                   rtol=0.0, atol=0.0)


@pytest.mark.cuda
def test_segment_max_counters_reset_across_calls(cuda):
    """Back-to-back calls on one stream whose row counts grow and shrink
    (the hub rows' arrival counters are grown, never shrunk, and each call
    leaves them at 0): every call bit-equal to the plain version."""
    layouts = k5_layouts()
    seq = ["hub_pieces", "powerlaw", "bounds", "hub_pieces", "powerlaw",
           "empty_runs", "powerlaw"]
    cases = {name: k5_on_card(layouts[name], 4, cuda, seed=3)
             for name in set(seq)}
    outs = [(name, segment_max(*cases[name][:4])) for name in seq]
    torch.cuda.synchronize()
    for name, got in outs:
        torch.testing.assert_close(got, cases[name][4], rtol=0.0, atol=0.0)
    device = cases["powerlaw"][0].device
    stream = torch.cuda.current_stream(device).cuda_stream
    assert not arrival_counters(device, stream, 0).any()


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


def disagreement(name, agree, gk, gp, uk, up, plain_grads) -> str:
    """Where a leaf's updates disagree: the share that agrees, the first
    element that does (its gradient and update in the kernel and plain
    steps) and the step's largest gradient."""
    j = tuple((~agree).nonzero()[0].tolist())
    return (f"{name}: {float(agree.float().mean())} of the updates agree; "
            f"{name}{list(j)}: gradient {float(gk[j]):.4g} / "
            f"{float(gp[j]):.4g}, update {float(uk[j]):.4g} / "
            f"{float(up[j]):.4g}; the step's largest gradient "
            f"{max(float(g.abs().max()) for g in plain_grads):.3g}")


def warm_pair(trainer_cls, cfg, model, graph, banks, steps: int = 3):
    """A trainer through the kernels after ``steps`` steps of its first
    epoch, and a trainer through the plain versions with a copy of its
    model and of its warm Adam state (as chip_smoke.py's ``same_step``
    takes them).  On Adam's first step an element whose gradient lies near
    eps (1e-8) moves by lr x its sign, so float noise in such a gradient
    flips a whole update; warm moments scale each update by the gradient's
    history instead."""
    import copy

    from kgc_gcn_torch.train import optim
    kernel = trainer_cls(cfg, model, graph, banks)
    kernel.train_epoch(1, np.random.default_rng(0), max_steps=steps)
    plain = trainer_cls(cfg, copy.deepcopy(model), graph, banks, plain=True)
    plain.opt_state = optim.AdamState(
        kernel.opt_state.count, [m.clone() for m in kernel.opt_state.mu],
        [v.clone() for v in kernel.opt_state.nu])
    return kernel, plain


@pytest.mark.cuda
def test_rgat_kernel_step_matches_plain_step(cuda):
    """One 2-layer, 4-head RGAT + DistMult 1-vs-all step with dropout
    through K5/K1, from a warm Adam state (``warm_pair``), and the same step
    (same weights, moments and dropout masks) through the plain versions:
    loss, gradients and updates."""
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
    cfg = dataset_preset("Toy", model="rgat", decoder="distmult", num_heads=4,
                         num_layers=2, gcn_in_dim=16, gcn_out_dim=32,
                         batch_size=16, gcn_drop=0.2, seed=5)
    model = build_model(cfg, ds.num_entity, ds.num_relation,
                        ds.num_edge).to(cuda)
    with torch.no_grad():        # the attention bias starts at zero
        for layer in model.layers:
            layer.rel_bias.normal_(0.0, 0.5)
    kernel, plain = warm_pair(Trainer, cfg, model, graph, banks)
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
    names = jax_leaf_names(cfg)[0]
    for i, (gk, gp) in enumerate(zip(out["kernel"][1], out["plain"][1])):
        assert torch.isfinite(gk).all(), names[i]
        torch.testing.assert_close(gk, gp, rtol=1e-4,
                                   atol=1e-4 * float(gp.abs().max()),
                                   msg=names[i])
        uk = kernel.params[i].detach() - before[i]
        up = plain.params[i].detach() - before[i]
        agree = torch.isclose(uk, up, rtol=1e-3, atol=1e-7)
        assert float(agree.float().mean()) > 0.999, disagreement(
            names[i], agree, gk, gp, uk, up, out["plain"][1])


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


def k3_counts():
    """K3's cases, (per-row counts, d): case_counts(), and around K3's chunk
    of 32 edges: a hub of many chunks between empty rows at d 100, rows of
    32 and 33 edges (and 31, 64, 65, ...) at d 4, 37, 100 and 200, and the
    stacked view's two padding hubs (the last row of each half) at d 100."""
    rng = np.random.default_rng(5)
    many = rng.integers(0, 3, size=60)
    many[[0, 20, 22, 59]] = 0
    many[21] = 5000                                    # 157 chunks
    bounds = case_counts()["chunk_bounds"][0]
    halves = rng.integers(0, 5, size=80)
    halves[[39, 79]] = 205
    return {**case_counts(), "many_chunks_d100": (many, 100),
            "padding_hubs_d100": (halves, 100),
            **{f"chunk_bounds_d{d}": (bounds, d) for d in (4, 37, 100, 200)}}


@pytest.mark.cuda
@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("case", sorted(k3_counts()))
def test_fused_compose_kernel_matches_plain(cuda, case, real):
    """K3 against its plain version: bit-equal on dyadic inputs; on normal
    values float32 sums in another order (rtol 1e-5, atol 1e-5 x max)."""
    from kgc_gcn_torch.ops.fused_compose import (
        fused_compose, fused_compose_reference)
    counts, d = k3_counts()[case]
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
@pytest.mark.parametrize("case", ["many_chunks_d100", "padding_hubs_d100",
                                  "zipf", "chunk_bounds_d37"])
def test_fused_compose_is_deterministic(cuda, case):
    """K3 on normal values, whose float32 sums depend on their order: each
    row's order is fixed (edge order within a chunk, then the chunks in
    order), so repeated calls give the same bits."""
    from kgc_gcn_torch.ops.fused_compose import fused_compose
    counts, d = k3_counts()[case]
    args = stacked_case(counts, d, seed=3, real=True)
    first = fused_compose(*args)
    for _ in range(2):
        assert torch.equal(first, fused_compose(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("lead,cut", [(0, 40), (37, 0), (64, 33)])
def test_fused_compose_ignores_edges_outside_the_rows(cuda, lead, cut):
    """indptr[0] > 0 or indptr[-1] < E: the edges before and after belong to
    no row and must not be read (their src and rel lie out of range here, so
    a read would fault on the device's bounds assertion)."""
    from kgc_gcn_torch.ops.fused_compose import (
        fused_compose, fused_compose_reference)
    counts = np.array([0, 3, 40, 0, 0, 33, 1, 70, 0])
    x, src, norm, rel_all, rel, etab, dst, indptr, n_rows = stacked_case(
        counts, 36, seed=4, real=False)

    def pad(t, lo, hi):
        fill = lambda n, v: torch.full((n,) + t.shape[1:], v, dtype=t.dtype,
                                       device=t.device)
        return torch.cat([fill(lead, lo), t, fill(cut, hi)])

    got = fused_compose(x, pad(src, 1 << 30, 1 << 30), pad(norm, 1.0, 1.0),
                        rel_all, pad(rel, -1, -1), pad(etab, 1.0, 1.0),
                        pad(dst, 0, n_rows - 1), indptr + lead, n_rows)
    torch.cuda.synchronize()
    want = fused_compose_reference(x, src, norm, rel_all, rel, etab, dst,
                                   indptr, n_rows)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


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


@pytest.mark.cuda
@pytest.mark.parametrize("case,fields,per_step", [
    ("mgcn_2_layers_corr", dict(num_layers=2, composition="corr"),
     dict(K1=8)),
    ("mgcn_complex_fused", dict(decoder="complex", loss_impl="fused"),
     dict(K1=4, K2a=1, K2b=1)),
    ("rgcn_rotate_negatives", dict(model="rgcn", decoder="rotate",
                                   num_bases=4, num_negatives=8,
                                   train_mode="negative_sampling"),
     dict(K1=2, K7=2, K8=2))])
def test_model_surface_kernel_step_matches_plain_step(cuda, case, fields,
                                                      per_step):
    """One training step with dropout of a configuration of the model
    surface (a 2-layer corr MGCN; MGCN + ComplEx on the fused loss; R-GCN +
    RotatE on sampled negatives) through the kernels and through the plain
    versions (same weights, warm Adam moments, negatives and dropout masks;
    ``warm_pair``): launches, loss, gradients and updates."""
    from kgc_gcn_torch.config import dataset_preset
    from kgc_gcn_torch.convert import jax_leaf_names
    from kgc_gcn_torch.data.batching import make_banks
    from kgc_gcn_torch.data.dataset import build_dataset
    from kgc_gcn_torch.data.graph import build_graph
    from kgc_gcn_torch.data.toy import toy_triples
    from kgc_gcn_torch.models import build_model
    from kgc_gcn_torch.train import optim
    from kgc_gcn_torch.train.loop import Trainer
    from kgc_gcn_torch.train.negative import NegativeSamplingTrainer

    counters = {"K1": segment_sum, "K2a": dense_loss, "K2b": dense_grads,
                "K7": basis_segment_sum, "K8": basis_backward}
    ds = build_dataset("toy", *toy_triples(n_ent=40, n_rel=5, n_train=300))
    graph = build_graph(ds.train_triples, ds.num_entity,
                        ds.num_relation).to(cuda)
    banks = make_banks(ds, cuda)
    cfg = dataset_preset("Toy", gcn_in_dim=16, gcn_out_dim=32, k_w=4, k_h=8,
                         num_filter=4, kernel_size=3, batch_size=16,
                         gcn_drop=0.2, feat_drop=0.2, hidden_drop=0.3, seed=5,
                         **fields)
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=graph.e_pad).to(cuda)
    trainer_cls = (NegativeSamplingTrainer
                   if cfg.train_mode == "negative_sampling" else Trainer)
    kernel, plain = warm_pair(trainer_cls, cfg, model, graph, banks)
    batch = kernel.batch(torch.arange(16, device=cuda),
                         torch.ones(16, device=cuda))
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
        assert torch.isfinite(gk).all(), name
        torch.testing.assert_close(gk, gp, rtol=1e-3,
                                   atol=1e-4 * float(gp.abs().max()), msg=name)
        assert torch.isfinite(kernel.params[i]).all(), name
        uk = kernel.params[i].detach() - before[i]
        up = plain.params[i].detach() - before[i]
        agree = torch.isclose(uk, up, rtol=1e-3, atol=1e-7)
        assert float(agree.float().mean()) > 0.999, disagreement(
            name, agree, gk, gp, uk, up, out["plain"][1])


@pytest.mark.cuda
@pytest.mark.parametrize("case,fields,knob,per_step", [
    ("mgcn_contrib_bf16", dict(use_pallas=True), ("scatter", "MGCN_CONTRIB"),
     dict(K1=4)),
    ("rgcn_readback_bf16", dict(model="rgcn", decoder="distmult",
                                num_bases=4, num_negatives=8, use_pallas=True,
                                train_mode="negative_sampling"),
     ("basis", "BASIS_READBACK"), dict(K1=2, K7=2, K8=2)),
    ("rgat_edge_contrib_bf16", dict(model="rgat", decoder="distmult",
                                    num_heads=4, use_pallas=True),
     ("sorted_ops", "EDGE_CONTRIB"), dict(K1=10, K5=2)),
    ("mgcn_operands", dict(use_pallas=True, bwd_perm="operands"), None,
     dict(K1=4)),
    ("mgcn_fwdw", dict(use_pallas=True, bwd_perm="fwdw"), None, dict(K1=4)),
    ("mgcn_fwdw_ew_pallas", dict(use_pallas=True, bwd_perm="fwdw",
                                 ew_impl="pallas"), None,
     dict(K1=4, K4a=2)),
    ("rgcn_block", dict(model="rgcn", decoder="distmult", num_bases=0,
                        num_blocks=4, num_negatives=8,
                        train_mode="negative_sampling"), None, dict(K1=4))])
def test_opt_in_path_kernel_step_matches_plain_step(cuda, monkeypatch, case,
                                                    fields, knob, per_step):
    """One training step of an opt-in path (a bf16 cotangent stream set to
    bf16, a ``bwd_perm`` schedule, R-GCN block mode) through the kernels and
    through the plain versions under the same knob (same weights, warm Adam
    moments, negatives and dropout masks; ``warm_pair``): launches, loss,
    gradients and updates.  The bf16 streams round the same float32
    cotangents to bf16 on both sides and sum them in float32."""
    import importlib

    from kgc_gcn_torch.config import dataset_preset
    from kgc_gcn_torch.convert import jax_leaf_names
    from kgc_gcn_torch.data.batching import make_banks
    from kgc_gcn_torch.data.dataset import build_dataset
    from kgc_gcn_torch.data.graph import build_graph
    from kgc_gcn_torch.data.toy import toy_triples
    from kgc_gcn_torch.models import build_model
    from kgc_gcn_torch.ops.elementwise import bwd_products, compose_msg
    from kgc_gcn_torch.train import optim
    from kgc_gcn_torch.train.loop import Trainer
    from kgc_gcn_torch.train.negative import NegativeSamplingTrainer

    if knob is not None:
        module = importlib.import_module(f"kgc_gcn_torch.ops.{knob[0]}")
        monkeypatch.setattr(module, knob[1], "bf16")
    counters = {"K1": segment_sum, "K7": basis_segment_sum,
                "K8": basis_backward, "K5": segment_max, "K4a": compose_msg,
                "K4b": bwd_products}
    ds = build_dataset("toy", *toy_triples(n_ent=40, n_rel=5, n_train=300))
    graph = build_graph(ds.train_triples, ds.num_entity,
                        ds.num_relation).to(cuda)
    banks = make_banks(ds, cuda)
    cfg = dataset_preset("Toy", gcn_in_dim=16, gcn_out_dim=32, k_w=4, k_h=8,
                         num_filter=4, kernel_size=3, batch_size=16,
                         gcn_drop=0.2, feat_drop=0.2, hidden_drop=0.3, seed=5,
                         **fields)
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=graph.e_pad).to(cuda)
    if cfg.model == "rgat":
        with torch.no_grad():        # the attention bias starts at zero
            for layer in model.layers:
                layer.rel_bias.normal_(0.0, 0.5)
    trainer_cls = (NegativeSamplingTrainer
                   if cfg.train_mode == "negative_sampling" else Trainer)
    kernel, plain = warm_pair(trainer_cls, cfg, model, graph, banks)
    batch = kernel.batch(torch.arange(16, device=cuda),
                         torch.ones(16, device=cuda))
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
    torch.testing.assert_close(out["kernel"][0], out["plain"][0], rtol=1e-5,
                               atol=0.0)
    for i, name in enumerate(jax_leaf_names(cfg)[0]):
        if name in ("decoder.bn0.scale", "decoder.bn0.bias"):
            continue   # BN1 cancels them: float noise on both sides
        gk, gp = out["kernel"][1][i], out["plain"][1][i]
        assert torch.isfinite(gk).all(), name
        torch.testing.assert_close(gk, gp, rtol=1e-3,
                                   atol=1e-4 * float(gp.abs().max()), msg=name)
        uk = kernel.params[i].detach() - before[i]
        up = plain.params[i].detach() - before[i]
        agree = torch.isclose(uk, up, rtol=1e-3, atol=1e-7)
        assert float(agree.float().mean()) > 0.999, disagreement(
            name, agree, gk, gp, uk, up, out["plain"][1])


@pytest.mark.cuda
def test_trace_checkpoints_and_reference_import_on_the_card(cuda, tmp_path):
    """On the card: a traced training step names K1's passes; a periodic
    checkpoint of the card's parameters holds their values at the save,
    though they change in place right after it; the reference checkpoint of
    a card model, imported back, gives the same encode to the bit."""
    import gzip
    import json
    import os

    from kgc_gcn_torch.config import dataset_preset
    from kgc_gcn_torch.data.batching import make_banks
    from kgc_gcn_torch.data.dataset import build_dataset
    from kgc_gcn_torch.data.graph import build_graph
    from kgc_gcn_torch.data.toy import toy_triples
    from kgc_gcn_torch.models import build_model
    from kgc_gcn_torch.train.checkpoint import (
        AsyncCheckpointer, load_checkpoint)
    from kgc_gcn_torch.train.loop import Trainer
    from kgc_gcn_torch.utils.profiling import trace
    from kgc_gcn_torch.utils.torch_import import (
        apply_reference_state_dict, load_reference_checkpoint,
        save_reference_checkpoint)

    ds = build_dataset("toy", *toy_triples(n_ent=40, n_rel=5, n_train=300))
    graph = build_graph(ds.train_triples, ds.num_entity,
                        ds.num_relation).to(cuda)
    banks = make_banks(ds, cuda)
    cfg = dataset_preset("Toy", gcn_in_dim=16, gcn_out_dim=32, k_w=4, k_h=8,
                         num_filter=4, kernel_size=3, batch_size=16, seed=5)
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=graph.e_pad).to(cuda)
    trainer = Trainer(cfg, model, graph, banks)
    prof = tmp_path / "prof"
    with trace(str(prof)):
        trainer.train_epoch(1, np.random.default_rng(0), max_steps=2)
    (name,) = os.listdir(prof)
    with gzip.open(prof / name, "rt") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("chunk_sums" in n for n in names), sorted(names)[:20]

    want = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    writer = AsyncCheckpointer()
    path = writer.save_checkpoint_async(str(tmp_path), model,
                                        trainer.opt_state, cfg, 0.5)
    trainer.train_epoch(1, np.random.default_rng(1), max_steps=2)
    writer.wait_for_async_checkpoints()
    sd, measure = load_checkpoint(path, cfg)
    assert measure == 0.5
    for k, v in want.items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0, msg=k)

    model.eval()
    ref = str(tmp_path / "ref.ckpt")
    save_reference_checkpoint(ref, model, graph)
    other = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=graph.e_pad)
    apply_reference_state_dict(other, load_reference_checkpoint(ref,
                                                                graph)[0])
    other = other.to(cuda).eval()
    with torch.no_grad():
        a, b = model.encode(graph)[0], other.encode(graph)[0]
    assert torch.equal(a, b)


def _toy_graph(device):
    from kgc_gcn_torch.data.dataset import build_dataset
    from kgc_gcn_torch.data.graph import build_graph
    from kgc_gcn_torch.data.toy import toy_triples
    ds = build_dataset("toy", *toy_triples(n_ent=60, n_rel=5, n_train=500))
    return ds, build_graph(ds.train_triples, ds.num_entity, ds.num_relation)


@pytest.mark.cuda
@pytest.mark.parametrize("g_size", [2, 4])
def test_per_shard_aggregates_sum_to_the_whole_on_the_card(cuda, g_size):
    """Graph axis G without a process group: each shard's aggregate of its
    edge slice (K1 over the local CSR, forward and d_x) summed over the
    shards equals the whole halves' aggregate through K1, and the per-edge
    table's gradient is the shards' slices side by side; float32 sums in
    another order (the norms are no dyadic numbers)."""
    from kgc_gcn_torch.ops.scatter import aggregate_half
    from kgc_gcn_torch.parallel.edge_parallel import (
        local_half, make_pallas_sharded_aggregate)
    ds, graph = _toy_graph(cuda)
    n, d = graph.n_ent, 24
    gen = torch.Generator().manual_seed(3)
    x, rel, etab, cot = (torch.randn(s, generator=gen).to(cuda) for s in (
        (n, d), (2 * graph.n_rel + 1, d), (2, graph.e_pad, d), (2, n, d)))
    halves = (graph.inb.to(cuda), graph.outb.to(cuda))

    def run(agg):
        xs, rs, es = (t.clone().requires_grad_() for t in (x, rel, etab))
        start = segment_sum.launches
        out = agg(xs, rs, es)
        grads = torch.autograd.grad(sum((o * c).sum() for o, c in
                                        zip(out, cot)), (xs, rs, es))
        return out, grads, segment_sum.launches - start

    whole = run(lambda xs, rs, es: [aggregate_half(xs, rs, es[i], h, n)
                                    for i, h in enumerate(halves)])
    e_loc = graph.e_pad // g_size
    agg = make_pallas_sharded_aggregate(None, n)

    def sharded(xs, rs, es):
        parts = [agg(xs, rs, (es[0, r * e_loc:(r + 1) * e_loc],
                              es[1, r * e_loc:(r + 1) * e_loc]),
                     [local_half(h, g_size, r).to(cuda) for h in halves])
                 for r in range(g_size)]
        return [sum(p[i] for p in parts) for i in range(2)]

    shards = run(sharded)
    assert whole[2] == 4 and shards[2] == 4 * g_size   # forward and d_x
    for got, want in zip(shards[0] + list(shards[1]),
                         whole[0] + list(whole[1])):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.detach().abs().max()))


@pytest.mark.cuda
def test_rgat_sharded_attend_of_one_shard_equals_attend(cuda):
    """RGAT's per-shard attention (``attend_sharded``: K5 and K1 over the
    edge slice) on one shard, without a group, is the one-device
    attention: its output and the gradients of h and the attention
    parameters through K5 and K1; the launches of both halves."""
    from kgc_gcn_torch.models.rgat import RGATLayer
    from kgc_gcn_torch.ops.kernels import KERNELS
    ds, graph = _toy_graph(cuda)
    halves = (graph.inb.to(cuda), graph.outb.to(cuda))
    gen = torch.Generator().manual_seed(4)
    layer = RGATLayer(2 * graph.n_rel, 16, 32, 4, gen).to(cuda)
    with torch.no_grad():
        layer.rel_bias.normal_(0, 0.5, generator=None)
    h = torch.randn(graph.n_ent, 32, generator=gen).to(cuda)
    cot = torch.randn(2, graph.n_ent, 32, generator=gen).to(cuda)
    params = [h] + list(layer.parameters())
    outs = []
    for sharded in (False, True):
        hs = h.clone().requires_grad_()
        start = (segment_sum.launches, segment_max.launches)
        if sharded:
            res = layer.attend_sharded(hs, halves, graph.n_ent, KERNELS, None)
        else:
            res = [layer.attend(hs, half, graph.n_ent, KERNELS)
                   for half in halves]
        grads = torch.autograd.grad(sum((r * c).sum() for r, c in
                                        zip(res, cot)),
                                    [hs] + params[1:], allow_unused=True)
        outs.append((res, grads, (segment_sum.launches - start[0],
                                  segment_max.launches - start[1])))
    assert outs[0][2] == outs[1][2] == (10, 2)
    for got, want in zip(outs[1][0] + list(outs[1][1]),
                         outs[0][0] + list(outs[0][1])):
        if want is None:
            continue
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.detach().abs().max()))


def _entity_graph():
    """A toy graph of 61 entities, which 2 and 4 ranks do not divide."""
    from kgc_gcn_torch.data.dataset import build_dataset
    from kgc_gcn_torch.data.graph import build_graph
    from kgc_gcn_torch.data.toy import toy_triples
    ds = build_dataset("toy", *toy_triples(n_ent=61, n_rel=5, n_train=500))
    return build_graph(ds.train_triples, ds.num_entity, ds.num_relation)


def _grads_of(fn, inputs, cot):
    """``fn``'s outputs and the gradients of ``Σ out · cot`` in ``inputs``,
    with the K1 and K5 launches it made."""
    xs = [t.clone().requires_grad_() for t in inputs]
    start = (segment_sum.launches, segment_max.launches)
    out = fn(*xs)
    grads = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cot)),
                                xs)
    return (list(out) + list(grads),
            (segment_sum.launches - start[0], segment_max.launches - start[1]))


def _assert_forms_equal(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-5 * float(w.detach().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("g_size", [2, 4])
def test_gather_schedule_k1_per_shard_matches_plain(cuda, g_size):
    """Each rank's share of the entity-sharded gather schedule, without a
    process group (its all_gather and reduce-scatter are then the
    identity): K1 over the rank's edge slice into the n_pad rows, forward
    and the gradients in x, the relation table and the table slice, equals
    the plain compose and index_add_ of the same slice; 4 K1 launches a
    rank (forward and d_x of two halves).  Float32 sums in another order."""
    from kgc_gcn_torch.parallel.edge_parallel import (
        local_half, make_entity_sharded_aggregate,
        make_entity_sharded_aggregate_pallas)
    graph = _entity_graph()
    n_pad = -(-graph.n_ent // g_size) * g_size
    e_loc, d = graph.e_pad // g_size, 24
    gen = torch.Generator().manual_seed(5)
    x, rel, etab, cot = (torch.randn(s, generator=gen).to(cuda) for s in (
        (n_pad, d), (2 * graph.n_rel + 1, d), (2, graph.e_pad, d),
        (2, n_pad, d)))
    x[graph.n_ent:] = 0.0
    kernel = make_entity_sharded_aggregate_pallas(None, n_pad)
    plain = make_entity_sharded_aggregate(None, n_pad)
    for r in range(g_size):
        halves = [local_half(h, g_size, r, n_pad).to(cuda)
                  for h in (graph.inb, graph.outb)]
        inputs = (x, rel, etab[:, r * e_loc:(r + 1) * e_loc].contiguous())
        runs = [_grads_of(lambda xs, rs, es, agg=agg: agg(
            xs, rs, (es[0], es[1]), halves), inputs, cot)
            for agg in (kernel, plain)]
        assert runs[0][1] == (4, 0) and runs[1][1] == (0, 0), runs
        _assert_forms_equal(runs[0][0], runs[1][0])


@pytest.mark.cuda
@pytest.mark.parametrize("g_size", [2, 4])
def test_boundary_k1_per_block_matches_plain(cuda, g_size):
    """Each rank's boundary aggregate of each half without a process group
    (its ppermutes are then the identity): K1 per block over the d_max
    compressed rows (forward and d_x, each block a GraphHalf of its own)
    equals the plain compose and index_add_ per block, forward and the
    gradients in the rank's rows, the relation table and the table slice;
    2 K1 launches a block."""
    from kgc_gcn_torch.parallel.boundary import (
        build_boundary_plan, make_boundary_aggregate)
    from kgc_gcn_torch.parallel.edge_parallel import local_half
    graph = _entity_graph()
    n_pad = -(-graph.n_ent // g_size) * g_size
    e_loc, d = graph.e_pad // g_size, 24
    gen = torch.Generator().manual_seed(6)
    rel = torch.randn(2 * graph.n_rel + 1, d, generator=gen).to(cuda)
    for half in (graph.inb, graph.outb):
        plan, _ = build_boundary_plan(half, g_size, n_pad)
        for r in range(g_size):
            local = local_half(half, g_size, r).to(cuda)
            x, cot = (torch.randn(plan.rows_per, d, generator=gen).to(cuda)
                      for _ in range(2))
            et = torch.randn(e_loc, d, generator=gen).to(cuda)
            runs = [_grads_of(
                lambda xs, rs, es, agg=make_boundary_aggregate(
                    None, plan, local, use_kernel, rank=r): [agg(xs, rs, es)],
                (x, rel, et), [cot]) for use_kernel in (True, False)]
            blocks = 1 + len(plan.t_steps)
            assert runs[0][1] == (2 * blocks, 0), runs[0][1]
            assert runs[1][1] == (0, 0)
            _assert_forms_equal(runs[0][0], runs[1][0])


@pytest.mark.cuda
@pytest.mark.parametrize("g_size", [2, 4])
def test_rgat_entity_sharded_attend_matches_plain(cuda, g_size):
    """RGAT's entity-sharded attend (``attend_sharded(entity_rows=True)``)
    of each rank's edge slices over the n_pad rows, without a process
    group: through K5 and K1 it equals its plain form, output and the
    gradients of h and the attention parameters; K5 2 and K1 10 launches
    a rank."""
    from kgc_gcn_torch.models.rgat import RGATLayer
    from kgc_gcn_torch.ops.kernels import KERNELS
    from kgc_gcn_torch.parallel.edge_parallel import local_half
    graph = _entity_graph()
    n_pad = -(-graph.n_ent // g_size) * g_size
    gen = torch.Generator().manual_seed(7)
    layer = RGATLayer(2 * graph.n_rel, 16, 32, 4, gen).to(cuda)
    with torch.no_grad():
        layer.rel_bias.normal_(0, 0.5, generator=None)
    h = torch.randn(n_pad, 32, generator=gen).to(cuda)
    cot = torch.randn(2, n_pad, 32, generator=gen).to(cuda)
    params = list(layer.parameters())
    for r in range(g_size):
        halves = [local_half(half, g_size, r, n_pad).to(cuda)
                  for half in (graph.inb, graph.outb)]
        runs = []
        for kernels in (KERNELS, PLAIN):
            hs = h.clone().requires_grad_()
            start = (segment_sum.launches, segment_max.launches)
            res = layer.attend_sharded(hs, halves, n_pad, kernels, None,
                                       entity_rows=True)
            grads = torch.autograd.grad(
                sum((o * c).sum() for o, c in zip(res, cot)),
                [hs] + params, allow_unused=True)
            runs.append((res + [g for g in grads if g is not None],
                         (segment_sum.launches - start[0],
                          segment_max.launches - start[1])))
        assert runs[0][1] == (10, 2) and runs[1][1] == (0, 0), runs
        _assert_forms_equal(runs[0][0], runs[1][0])
