"""Plain reference of basis R-GCN + DistMult on sampled negatives
(Schlichtkrull et al. 2018, arXiv:1703.06103, eq. 2-3; BASELINE config 3):

    h_i = ReLU( Σ_{r} Σ_{j ∈ N_i^r} norm_ij · x_j W_r  +  x_i W_self ),
    W_r = Σ_b coeff[r, b] · basis[b],

over both directions of every train triple (the reverse of relation r is
relation r + R), then dropout; DistMult scores ⟨e_s ∘ w_r, e_o⟩ + b_o for the
true object and K entities drawn uniformly, under BCE, clipping and Adam.

Each relation's messages are projected through its own W_r and summed with
``index_add_``, one relation at a time.  The negatives and the dropout mask
of a step are drawn, in that order, from one generator seeded as the
trainer's.  Products run in ``precision``: ``float64`` (the
training check the benchmark compares against), ``float32``, or
``tf32`` (the control).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.lib.weights import Leaf, xavier
from benchmark.reference import common as C


def leaves(dims: dict, cfg: dict) -> List[Leaf]:
    n, r2 = dims["n_ent"], 2 * dims["n_rel"]
    din, dout, nb = cfg["gcn_in_dim"], cfg["gcn_out_dim"], cfg["num_bases"]
    return [xavier("entity_embedding", (n, din), din, n),
            xavier("relation_embedding", (r2, dout), dout, r2),
            xavier("layers.0.basis", (nb, din, dout), din * dout, nb * dout),
            xavier("layers.0.coeff", (r2, nb), nb, r2),
            xavier("layers.0.self_weight", (din, dout), dout, din),
            Leaf("decoder.ent_bias", (n,), -0.1, 0.1)]


def trainable(name: str) -> bool:
    return True


def encode(w: Dict[str, torch.Tensor], halves: List[C.Half], n_ent: int,
           cfg: dict, gen: Optional[torch.Generator], precision: str):
    x = w["entity_embedding"]
    basis, coeff = w["layers.0.basis"], w["layers.0.coeff"]
    nb, din, dout = basis.shape
    w_rel = C.mm(coeff, basis.reshape(nb, din * dout), precision).reshape(
        -1, din, dout)                                      # (2R, d_in, d_out)
    h = C.mm(x, w["layers.0.self_weight"], precision)
    for half in halves:
        order = torch.argsort(half.rel, stable=True)
        counts = torch.bincount(half.rel, minlength=coeff.shape[0]).tolist()
        lo = 0
        for rel_id, cnt in enumerate(counts):
            if cnt:
                e = order[lo:lo + cnt]
                msg = C.mm(x[half.src[e]] * half.norm[e, None], w_rel[rel_id],
                           precision)
                h = h.index_add(0, half.dst[e], msg)
            lo += cnt
    x = torch.relu(h)
    if gen is not None:
        x = C.dropout(x, cfg["gcn_drop"], gen)
    return x, w["relation_embedding"]


def train_check(kg, weights: Dict[str, torch.Tensor], rows: List[np.ndarray],
                cfg: dict, seed: int, device, precision: str = "float32",
                fault: Optional[str] = None) -> dict:
    """The first steps of negative-sampling training from ``weights``, step
    i on the positives ``rows[i]`` (indices into the CSR-ordered positive
    triples): each step's loss, each leaf's norm of the first (clipped)
    gradient, and each leaf's norm of its change after the last step."""
    C.pin_float32()
    dt = C.dtype(precision)
    weights = {k: v.to(dt) for k, v in weights.items()}
    n, n_rel = kg.n_ent, kg.n_rel
    train = kg.triples["train"]
    halves = C.halves(train, n, n_rel, device)
    positives = torch.as_tensor(C.positive_order(train, n_rel), device=device)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in weights.items()}
    gen = torch.Generator(device=device).manual_seed(seed % 2**32)
    state, losses, first = {}, [], None
    n_neg = cfg["num_negatives"]
    for step_rows in rows:
        tri = positives[torch.as_tensor(step_rows, device=device)]
        b = tri.shape[0]
        neg = torch.randint(0, n, (b, n_neg), generator=gen, device=device)
        mask = C.fault_mask(torch.ones(b, device=device, dtype=dt), fault)
        ent, rel = encode(params, halves, n, cfg, gen, precision)
        cand = torch.cat([tri[:, 2:3], neg], dim=1)                # (B, 1+K)
        q = ent[tri[:, 0]] * rel[tri[:, 1]]
        logits = (C.mm(ent[cand], q[:, :, None], precision)[:, :, 0]
                  + params["decoder.ent_bias"][cand])
        target = torch.zeros_like(logits)
        target[:, 0] = 1.0
        per = F.binary_cross_entropy_with_logits(logits, target,
                                                 reduction="none")
        loss = ((per * mask[:, None]).sum()
                / (mask.sum().clamp_min(1.0) * logits.shape[1]))
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
