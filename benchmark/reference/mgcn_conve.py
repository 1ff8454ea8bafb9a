"""Plain reference of MGCN + ConvE (weilonghu/KGC-GCN ``model.py``): one
relational layer with per-edge embeddings and the ``mult`` composition,
ConvE on the encoded tables, 1-vs-all BCE on smoothed labels, clipping and
Adam.

Every sum over edges is an ``index_add_`` over the triples in their own
order; the per-edge table has one row per edge of either half, in triple
order (rows 0..E-1 the triples, E..2E-1 their reverses).  Dropout masks
are drawn from one generator seeded as the trainer's, site by site in the
order a step reaches them: ``conv_in`` and ``conv_out`` on the two
direction results, ``gcn`` on the encoded entities, then ConvE's ``feat``
and ``hidden``.  Products run in ``precision``: ``float64`` (the
training check the benchmark compares against), ``float32`` (the
evaluation's), or ``tf32`` (the control).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.lib.weights import Leaf, xavier
from benchmark.reference import common as C


def leaves(dims: dict, cfg: dict) -> List[Leaf]:
    """The initial tensors, under the names of the program's state and in
    the shapes above; BatchNorm's running statistics among them."""
    n, r2, e = dims["n_ent"], 2 * dims["n_rel"], dims["n_edge"]
    din, dout = cfg["gcn_in_dim"], cfg["gcn_out_dim"]
    k, f = cfg["kernel_size"], cfg["num_filter"]
    flat = conve_flat(cfg)
    out = [xavier("entity_embedding", (n, din), din, n),
           xavier("relation_embedding", (r2, din), din, r2),
           xavier("edge_embeddings", (2 * e, din), din, 2 * e)]
    for w in ("in", "out", "loop", "rels"):
        out.append(xavier(f"conv.{w}_weight", (din, dout), dout, din))
    out += [xavier("conv.loop_rel", (1, din), din, 1),
            xavier("conv.loop_edge", (1, din), din, 1)]
    bns = {"conv.bn": dout, "decoder.bn0": 1, "decoder.bn1": f,
           "decoder.bn2": dout}
    for name, c in bns.items():
        out += [Leaf(f"{name}.scale", (c,), 0.8, 1.2),
                Leaf(f"{name}.bias", (c,), -0.1, 0.1),
                Leaf(f"{name}.mean", (c,), -0.1, 0.1),
                Leaf(f"{name}.var", (c,), 0.5, 1.5)]
    b_conv, b_fc = 1.0 / k, 1.0 / flat ** 0.5
    out += [Leaf("decoder.conv_w", (f, 1, k, k), -b_conv, b_conv),
            Leaf("decoder.fc_w", (dout, flat), -b_fc, b_fc),
            Leaf("decoder.fc_b", (dout,), -b_fc, b_fc),
            Leaf("decoder.ent_bias", (n,), -0.1, 0.1)]
    return out


def trainable(name: str) -> bool:
    return not name.endswith((".mean", ".var"))


def conve_flat(cfg: dict) -> int:
    oh = 2 * cfg["k_w"] - cfg["kernel_size"] + 1
    ow = cfg["k_h"] - cfg["kernel_size"] + 1
    return oh * ow * cfg["num_filter"]


def encode(w: Dict[str, torch.Tensor], halves: List[C.Half], n_ent: int,
           cfg: dict, gen: Optional[torch.Generator], precision: str):
    """(entities (N, d_out), relations (2R, d_out)); in training (``gen``
    given) on batch statistics and with dropout, else on the running
    statistics."""
    x = w["entity_embedding"]
    rel_all = torch.cat([w["relation_embedding"], w["conv.loop_rel"]])
    table = w["edge_embeddings"]
    res = []
    for h, name in zip(halves, ("conv.in_weight", "conv.out_weight")):
        msg = x[h.src] * rel_all[h.rel] * table[h.row] * h.norm[:, None]
        agg = torch.zeros(n_ent, x.shape[1], device=x.device,
                          dtype=x.dtype).index_add(
            0, h.dst, msg)
        res.append(C.mm(agg, w[name], precision))
    loop = C.mm(x * w["conv.loop_rel"] * w["conv.loop_edge"],
                w["conv.loop_weight"], precision)
    train = gen is not None
    if train:
        res = [C.dropout(t, cfg["conv_drop"], gen) for t in res]
    out = (res[0] + res[1] + loop) / 3.0
    stats = () if train else (w["conv.bn.mean"], w["conv.bn.var"])
    ent = torch.tanh(C.batch_norm(out, w["conv.bn.scale"], w["conv.bn.bias"],
                                  *stats))
    rel = C.mm(rel_all, w["conv.rels_weight"], precision)[:-1]
    if train:
        ent = C.dropout(ent, cfg["gcn_drop"], gen)
    return ent, rel


def query(w: Dict[str, torch.Tensor], src: torch.Tensor, rel: torch.Tensor,
          cfg: dict, gen: Optional[torch.Generator],
          precision: str) -> torch.Tensor:
    """ConvE's query vector (B, d_out): the subject and relation rows
    interleaved into a (2 k_w, k_h) image, BN, convolution, BN, ReLU,
    dropout, projection, dropout, BN, ReLU (``model.py:159-175``)."""
    b = src.shape[0]
    train = gen is not None

    def bn(t, name, axis):
        stats = () if train else (w[f"{name}.mean"], w[f"{name}.var"])
        return C.batch_norm(t, w[f"{name}.scale"], w[f"{name}.bias"], *stats,
                            channel_axis=axis)

    img = torch.stack([src, rel], dim=1).transpose(1, 2).reshape(
        b, 1, 2 * cfg["k_w"], cfg["k_h"])
    x = C.conv2d(bn(img, "decoder.bn0", 1), w["decoder.conv_w"], precision)
    x = torch.relu(bn(x, "decoder.bn1", 1))
    if train:
        x = C.dropout(x, cfg["feat_drop"], gen)
    x = C.mm(x.reshape(b, -1), w["decoder.fc_w"].T, precision) + w["decoder.fc_b"]
    if train:
        x = C.dropout(x, cfg["hidden_drop"], gen)
    return torch.relu(bn(x, "decoder.bn2", -1))


def train_check(kg, weights: Dict[str, torch.Tensor], rows: List[np.ndarray],
                cfg: dict, seed: int, device, precision: str = "float32",
                fault: Optional[str] = None) -> dict:
    """The first steps of 1-vs-all training from ``weights``, step i on the
    train queries ``rows[i]`` (indices into the first-seen query order):
    each step's loss, each leaf's norm of the first (clipped) gradient, and
    each leaf's norm of its change after the last step."""
    C.pin_float32()
    dt = C.dtype(precision)
    weights = {k: v.to(dt) for k, v in weights.items()}
    n, n_rel = kg.n_ent, kg.n_rel
    train = kg.triples["train"]
    halves = C.halves(train, n, n_rel, device)
    index = C.train_index(train, n_rel)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in weights.items() if trainable(k)}
    w = dict(weights, **params)
    gen = torch.Generator(device=device).manual_seed(seed % 2**32)
    state, losses, first = {}, [], None
    for step_rows in rows:
        keys = index.first_seen[step_rows]
        s = torch.as_tensor(keys // (2 * n_rel), device=device)
        r = torch.as_tensor(keys % (2 * n_rel), device=device)
        labels = index.dense(keys, n, device).to(dt)
        mask = C.fault_mask(torch.ones(len(keys), device=device, dtype=dt),
                            fault)
        ent, rel = encode(w, halves, n, cfg, gen, precision)
        h = query(w, ent[s], rel[r], cfg, gen, precision)
        logits = C.mm(h, ent.T, precision) + w["decoder.ent_bias"]
        loss = C.bce_1vsall(logits, labels, cfg["lbl_smooth"], mask)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        clipped = C.clip_and_adam(params, grads, state, cfg["learning_rate"],
                                  cfg["clip_grad"])
        losses.append(float(loss.detach()))
        if first is None:
            first = C.leaf_norms(clipped)
    change = C.leaf_norms({k: params[k].detach() - weights[k]
                           for k in params})
    return {"loss": losses, "grad": first, "change": change}


def eval_blocks(kg, weights: Dict[str, torch.Tensor], cfg: dict, device,
                block: int, precision: str = "float32"):
    """The filtered test ranking, ``block`` queries at a time (tail queries
    then head queries, in the split's order): yields (first query index,
    masked scores, target scores, score spreads) per block."""
    C.pin_float32()
    n, n_rel = kg.n_ent, kg.n_rel
    halves = C.halves(kg.triples["train"], n, n_rel, device)
    filt = C.filter_index(kg.triples, n_rel)
    queries = C.eval_queries(kg.triples["test"], n_rel)
    with torch.no_grad():
        ent, rel = encode(weights, halves, n, cfg, None, precision)
        for lo in range(0, len(queries), block):
            q = queries[lo:lo + block]
            s = torch.as_tensor(q[:, 0], device=device)
            r = torch.as_tensor(q[:, 1], device=device)
            h = query(weights, ent[s], rel[r], cfg, None, precision)
            scores = C.mm(h, ent.T, precision) + weights["decoder.ent_bias"]
            yield (lo, *C.filtered_scores(scores, q, filt, n_rel))
