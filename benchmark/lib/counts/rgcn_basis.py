"""Work of basis R-GCN + DistMult on sampled negatives, counted from
shapes: float32 operations of the matrix products (no recompute, no
elementwise work, not K7's per-edge contraction), and the calls of each
hand-written kernel with the bytes and operations each needs
(``lib/roofline.py``).

One forward pass: per direction half the (N, B·d_in) x (B·d_in, d_out)
basis product, the (N, d_in) x (d_in, d_out) self term, and DistMult's
(1 + K) candidate dot products of each query.  A training step counts three
forwards.
"""

from __future__ import annotations

from benchmark.lib import roofline


def train_step_flops(dims: dict, cfg: dict) -> float:
    n, din, dout = dims["n_ent"], cfg["gcn_in_dim"], cfg["gcn_out_dim"]
    nb = cfg["num_bases"]
    encoder = 2.0 * n * din * dout * (2 * nb + 1)
    score = 2.0 * cfg["batch_size"] * (1 + cfg["num_negatives"]) * dout
    return 3.0 * (encoder + score)


def kernel_calls(dims: dict, cfg: dict, kind: str) -> dict:
    """``{Kernels field: [(bytes, ops) per call]}`` of one step: per half K7
    forward, K8 backward (reading g on the rows that have edges) and K1 for
    d_x over the src order."""
    e, n, d, nb = dims["e_pad"], dims["n_ent"], cfg["gcn_in_dim"], cfg["num_bases"]
    return {"basis_sum": [roofline.k7(e, n, d, nb)] * 2,
            "basis_bwd": [roofline.k8(e, rows, d, nb)
                          for rows in dims["rows_with_edges"]],
            "seg_sum": [roofline.k1(e, n, d)] * 2}
