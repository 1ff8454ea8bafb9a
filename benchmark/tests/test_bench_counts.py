"""The work counters against hand counts at a toy size."""

from benchmark.lib import roofline
from benchmark.lib.counts import mgcn_conve, rgcn_basis

CFG = {"gcn_in_dim": 4, "gcn_out_dim": 6, "k_w": 2, "k_h": 3,
       "kernel_size": 2, "num_filter": 5, "batch_size": 3, "num_bases": 2,
       "num_negatives": 4}
DIMS = {"n_ent": 10, "n_rel": 2, "n_edge": 20, "e_pad": 32,
        "rows_with_edges": [7, 9], "eval_queries": 8}


def test_mgcn_conve_flops():
    # encoder: 3 projections of (10, 4) x (4, 6) and (2R + 1 = 5, 4) x (4, 6)
    enc = 2 * 4 * 6 * (3 * 10 + 5)
    # a query: conv over a (4, 3) image by 2 x 2 filters: 3 x 2 positions,
    # 5 filters of 4 taps; fc (3*2*5 = 30) -> 6; scoring 6 x 10
    per_query = 2 * 6 * 4 * 5 + 2 * 30 * 6 + 2 * 6 * 10
    assert mgcn_conve.train_step_flops(DIMS, CFG) == 3 * (enc + 3 * per_query)
    assert mgcn_conve.eval_pass_flops(DIMS, CFG) == enc + 8 * per_query


def test_rgcn_basis_flops():
    # per half (10, 2*4) x (2*4, 6), self (10, 4) x (4, 6); 3 queries of 1+4
    # candidate dot products of 6
    fwd = 2 * (2 * 10 * 8 * 6) + 2 * 10 * 4 * 6 + 2 * 3 * 5 * 6
    assert rgcn_basis.train_step_flops(DIMS, CFG) == 3 * fwd


def test_kernel_bytes_and_ops():
    # K1: 32 x 4 float32 messages, 11 pointers, 10 x 4 outputs
    assert roofline.k1(32, 10, 4) == (32 * 4 * 4 + 4 * 11 + 4 * 10 * 4, 128)
    # K7: msg (32 x 4), a (32 x 2), indptr 11, out 10 x 8 floats
    assert roofline.k7(32, 10, 4, 2) == (4 * (128 + 64 + 11 + 80), 2.0 * 256)
    # K8: g on 7 rows of 8, msg and d_msg 32 x 4, a and d_a 32 x 2, dst 32
    assert roofline.k8(32, 7, 4, 2) == (4 * (56 + 256 + 128 + 32), 4.0 * 256)
    calls = rgcn_basis.kernel_calls(DIMS, CFG, "train")
    assert calls["basis_bwd"] == [roofline.k8(32, 7, 4, 2),
                                  roofline.k8(32, 9, 4, 2)]
    assert len(calls["seg_sum"]) == 2 and len(calls["basis_sum"]) == 2
    assert len(mgcn_conve.kernel_calls(DIMS, CFG, "train")["seg_sum"]) == 4
    assert len(mgcn_conve.kernel_calls(DIMS, CFG, "eval")["seg_sum"]) == 2


def test_bound_takes_the_larger_and_knows_its_card():
    card = "NVIDIA H100 80GB HBM3"
    assert roofline.bound_s(card, 3.35e12, 0) == 1.0
    assert roofline.bound_s(card, 0, 67e12) == 1.0
    assert roofline.bound_s("some other card", 1, 1) is None
