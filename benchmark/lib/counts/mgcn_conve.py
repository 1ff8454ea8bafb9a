"""Work of MGCN + ConvE, counted from shapes: float32 operations of the
matrix products and convolutions (no recompute, no elementwise work), and
the calls of each hand-written kernel with the bytes and operations each
needs (``lib/roofline.py``).

One forward pass: the encoder's three (N, d_in) x (d_in, d_out) projections
(in, out, loop) and the relations' (2R + 1, d_in) one; per query ConvE's
convolution (OH·OW positions of a k x k filter bank of F filters), its
(flat, d_out) projection and the (d_out, N) scoring product.  A training
step counts three forwards (forward and backward); an evaluation pass one
encoder and every query.
"""

from __future__ import annotations

from benchmark.lib import roofline


def _per_query(dims: dict, cfg: dict) -> float:
    k, f, dout = cfg["kernel_size"], cfg["num_filter"], cfg["gcn_out_dim"]
    oh = 2 * cfg["k_w"] - k + 1
    ow = cfg["k_h"] - k + 1
    return (2.0 * oh * ow * k * k * f + 2.0 * oh * ow * f * dout
            + 2.0 * dout * dims["n_ent"])


def _encoder(dims: dict, cfg: dict) -> float:
    din, dout = cfg["gcn_in_dim"], cfg["gcn_out_dim"]
    return 2.0 * din * dout * (3 * dims["n_ent"] + 2 * dims["n_rel"] + 1)


def train_step_flops(dims: dict, cfg: dict) -> float:
    return 3.0 * (_encoder(dims, cfg) + cfg["batch_size"] * _per_query(dims, cfg))


def eval_pass_flops(dims: dict, cfg: dict) -> float:
    return _encoder(dims, cfg) + dims["eval_queries"] * _per_query(dims, cfg)


def kernel_calls(dims: dict, cfg: dict, kind: str) -> dict:
    """``{Kernels field: [(bytes, ops) per call]}`` of one step or pass:
    K1 sums each direction half's (E_pad, d_in) messages into N rows, and in
    training also each half's src-ordered cotangents into d_x."""
    call = roofline.k1(dims["e_pad"], dims["n_ent"], cfg["gcn_in_dim"])
    return {"seg_sum": [call] * (4 if kind == "train" else 2)}
