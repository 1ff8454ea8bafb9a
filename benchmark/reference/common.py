"""What the plain references share: the graph, the query banks and the
filter worked out from the triples, dropout, BatchNorm, products in a stated
precision, clipping and Adam, and the ranking of the evaluation.

Plain PyTorch and NumPy only: nothing here imports the program, and nothing
takes anything the program made.  Each definition follows the reference
implementation's semantics (weilonghu/KGC-GCN ``data_loader.py`` and
``model.py``) as the configuration files state them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
BN_EPS = 1e-5


# ------------------------------------------------------------------ numerics

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties away),
    the operands of a TF32 tensor-core product."""
    i = x.detach().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` on TF32-rounded operands, forward and backward (each
    product of the backward rounds its operands too)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(round_tf32(a), round_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return (torch.matmul(g, round_tf32(b).transpose(-1, -2)),
                torch.matmul(round_tf32(a).transpose(-1, -2), g))


class _TF32Conv(torch.autograd.Function):
    """``conv2d(x, w)`` on TF32-rounded operands, forward and backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv2d(round_tf32(x), round_tf32(w))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g, xr, wr = round_tf32(g), round_tf32(x), round_tf32(w)
        return (torch.nn.grad.conv2d_input(x.shape, wr, g),
                torch.nn.grad.conv2d_weight(xr, w.shape, g))


def dtype(precision: str) -> torch.dtype:
    """The element type of a ``precision``: float64 for ``float64``, else
    float32 (``tf32`` rounds float32 operands itself)."""
    return torch.float64 if precision == "float64" else torch.float32


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` accumulated in the operands' type, the operands in
    ``precision`` (``float64``, ``float32`` or ``tf32``)."""
    if precision == "tf32":
        return _TF32MatMul.apply(a, b)
    return torch.matmul(a, b)


def conv2d(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return _TF32Conv.apply(x, w)
    return F.conv2d(x, w)


def pin_float32() -> None:
    """Float32 products and convolutions in float32 on the card (no TF32);
    the ``tf32`` precision rounds its operands itself."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dropout(x: torch.Tensor, p: float, gen: torch.Generator) -> torch.Tensor:
    """Inverted dropout; the keep mask is one uniform float32 draw of
    ``x``'s shape from ``gen`` (the same mask in every precision), kept
    where it is at least ``p``."""
    if p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device,
                      dtype=torch.float32) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def batch_norm(x: torch.Tensor, scale, bias, mean=None, var=None,
               channel_axis: int = -1) -> torch.Tensor:
    """BatchNorm over every axis but ``channel_axis``: on the batch's
    moments (biased variance) when ``mean`` is None, else on the given
    running statistics."""
    axis = channel_axis % x.dim()
    axes = [i for i in range(x.dim()) if i != axis]
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    if mean is None:
        mean = x.mean(dim=axes)
        var = x.var(dim=axes, unbiased=False)
    y = (x - mean.view(shape)) / torch.sqrt(var.view(shape) + BN_EPS)
    return y * scale.view(shape) + bias.view(shape)


def clip_and_adam(params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], state: dict, lr: float,
                  clip: float) -> Dict[str, torch.Tensor]:
    """Global-norm clipping (scaled by clip / norm when the norm is at least
    ``clip``), then one Adam step in place: (0.9, 0.999, eps 1e-8), the
    bias corrections 1 - beta^t in float32 and eps outside the root, as
    optax's ``scale_by_adam`` (the configurations' optimizer); returns the
    clipped gradients."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    scale = 1.0 if float(norm) < clip else clip / float(norm)
    clipped = {k: g * scale for k, g in grads.items()}
    state["t"] = state.get("t", 0) + 1
    bc1, bc2 = (float(np.float32(1) - np.float32(b) ** np.float32(state["t"]))
                for b in (B1, B2))
    with torch.no_grad():
        for k, g in clipped.items():
            m = state.setdefault(("m", k), torch.zeros_like(g))
            v = state.setdefault(("v", k), torch.zeros_like(g))
            m.mul_(B1).add_((1 - B1) * g)
            v.mul_(B2).add_((1 - B2) * g * g)
            params[k].sub_(lr * ((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)))
    return clipped


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.double()))
            for k, t in tensors.items()}


# --------------------------------------------------------------------- graph

@dataclass
class Half:
    """One direction of the bidirectional edge list, in triple order: the
    row of each edge in a (2E, d) per-edge table and its degree norm."""

    src: torch.Tensor
    dst: torch.Tensor
    rel: torch.Tensor
    row: torch.Tensor
    norm: torch.Tensor


def halves(train: np.ndarray, n_ent: int, n_rel: int, device) -> List[Half]:
    """The "in" half (s -> o, r, table rows 0..E-1) and the "out" half
    (o -> s, r + R, rows E..2E-1).  The norm of an edge is
    deg^-1/2[source] * deg^-1/2[destination], its half's degrees counted
    over the source column only (``model.py:72-80``)."""
    t = torch.as_tensor(train, device=device)
    s, r, o = t[:, 0], t[:, 1], t[:, 2]
    e = t.shape[0]
    out = []
    for src, dst, rel, base in ((s, o, r, 0), (o, s, r + n_rel, e)):
        deg = torch.bincount(src, minlength=n_ent).float()
        dinv = torch.where(deg > 0, deg.pow(-0.5), torch.zeros_like(deg))
        out.append(Half(src, dst, rel, base + torch.arange(e, device=device),
                        dinv[src] * dinv[dst]))
    return out


def positive_order(train: np.ndarray, n_rel: int) -> np.ndarray:
    """The positive triples of negative sampling, (2E, 3): the in half's
    edges ordered by object, then the out half's reversed edges ordered by
    subject, each sort stable over the triple order (CSR order)."""
    s, r, o = train[:, 0], train[:, 1], train[:, 2]
    fwd = np.argsort(o, kind="stable")
    rev = np.argsort(s, kind="stable")
    return np.concatenate([np.stack([s[fwd], r[fwd], o[fwd]], axis=1),
                           np.stack([o[rev], r[rev] + n_rel, s[rev]], axis=1)])


# ------------------------------------------------------ query banks, filters

def _stream(triples: np.ndarray, n_rel: int):
    """Keys (s * 2R + r) and values of the (s, r) -> o stream: per triple
    the tail entry, then the head entry (o, r + R) -> s."""
    s, r, o = (triples[:, i].astype(np.int64) for i in range(3))
    key = np.empty(2 * len(s), np.int64)
    val = np.empty(2 * len(s), np.int64)
    key[0::2], val[0::2] = s * (2 * n_rel) + r, o
    key[1::2], val[1::2] = o * (2 * n_rel) + r + n_rel, s
    return key, val


class LabelIndex:
    """Grouped (key -> values) of a stream, with its keys in first-seen
    order (``data_loader.py:80-102``)."""

    def __init__(self, key: np.ndarray, val: np.ndarray):
        uniq, first, inv = np.unique(key, return_index=True,
                                     return_inverse=True)
        self.sorted_keys = uniq
        self.first_seen = uniq[np.argsort(first, kind="stable")]
        order = np.argsort(inv, kind="stable")
        self.values = val[order]
        self.offsets = np.zeros(len(uniq) + 1, np.int64)
        np.cumsum(np.bincount(inv, minlength=len(uniq)), out=self.offsets[1:])

    def dense(self, keys: np.ndarray, n_ent: int, device) -> torch.Tensor:
        """(len(keys), n_ent) float32 multi-hot of each key's values."""
        g = np.searchsorted(self.sorted_keys, keys)
        lens = self.offsets[g + 1] - self.offsets[g]
        rows = np.repeat(np.arange(len(keys)), lens)
        cols = self.values[np.concatenate(
            [np.arange(self.offsets[i], self.offsets[i + 1]) for i in g])
            if len(g) else np.empty(0, np.int64)]
        y = torch.zeros(len(keys), n_ent, device=device)
        y[torch.as_tensor(rows, device=device),
          torch.as_tensor(cols, device=device)] = 1.0
        return y


def train_index(train: np.ndarray, n_rel: int) -> LabelIndex:
    """The train split's (s, r) -> objects, whose first-seen keys are the
    1-vs-all training queries."""
    return LabelIndex(*_stream(train, n_rel))


def filter_index(triples: Dict[str, np.ndarray], n_rel: int) -> LabelIndex:
    """Every split's (s, r) -> objects: the filter of the ranking."""
    keys, vals = zip(*(_stream(triples[s], n_rel)
                       for s in ("train", "valid", "test")))
    return LabelIndex(np.concatenate(keys), np.concatenate(vals))


def eval_queries(triples: np.ndarray, n_rel: int) -> np.ndarray:
    """The tail queries (s, r, o), then the head queries (o, r + R, s),
    (2T, 3) int64, in the split's order (``data_loader.py:104-110``)."""
    s, r, o = triples[:, 0], triples[:, 1], triples[:, 2]
    return np.concatenate([np.stack([s, r, o], axis=1),
                           np.stack([o, r + n_rel, s], axis=1)])


# -------------------------------------------------------------------- ranking

def filtered_scores(scores: torch.Tensor, queries: np.ndarray,
                    filt: LabelIndex, n_rel: int):
    """(masked, target, spread): ``scores`` with every known answer of each
    query, its own target included, set to -inf; the target's score; and
    the standard deviation of each row's scores."""
    keys = queries[:, 0] * (2 * n_rel) + queries[:, 1]
    known = filt.dense(keys, scores.shape[1], scores.device).bool()
    tgt = torch.as_tensor(queries[:, 2], device=scores.device)
    target = scores.gather(1, tgt[:, None])[:, 0]
    return (scores.masked_fill(known, float("-inf")), target,
            scores.std(dim=1))


def ranks(masked: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 + the number of entities scored above the target."""
    return 1 + (masked > target[:, None]).sum(dim=1)


def rank_gaps(masked: torch.Tensor, target: torch.Tensor,
              spread: torch.Tensor, claimed: torch.Tensor) -> torch.Tensor:
    """For each query, the least shift of the target's reference score, in
    units of its row's score spread, that makes the claimed rank the
    reference's: 0 where they agree; else the distance from the target's
    score to the score of the entity that the claim counts above it but the
    reference does not (claim higher), or the reverse (claim lower).  A
    claim past the unfiltered entities reads inf."""
    n = masked.shape[1]
    ref = ranks(masked, target)
    srt = masked.sort(dim=1, descending=True).values
    c = claimed.long() - 1                       # entities claimed above
    at = lambda i: srt.gather(1, i.clamp(0, n - 1)[:, None])[:, 0]
    gap = torch.zeros_like(target)
    gap = torch.where(claimed > ref, target - at(c - 1), gap)
    gap = torch.where(claimed < ref, at(c) - target, gap)
    gap = torch.where((c < 0) | (c > n), torch.full_like(gap, float("inf")),
                      gap)
    return gap / spread.clamp_min(1e-30)


def rank_metrics(r: np.ndarray) -> Dict[str, float]:
    """MR, MRR and hits@{1,3,10} over every rank given (tail and head
    queries together), ``main.py:84-133``."""
    r = np.asarray(r, np.float64)
    out = {"mr": float(r.mean()), "mrr": float((1.0 / r).mean())}
    for k in (1, 3, 10):
        out[f"hits@{k}"] = float((r <= k).mean())
    return out


def bce_1vsall(logits: torch.Tensor, labels: torch.Tensor, smooth: float,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean BCE over the valid rows and every entity, on labels smoothed as
    (1 - eps) * y + 1 / N (``data_loader.py:41-51``, ``main.py:62``)."""
    n = logits.shape[1]
    y = (1.0 - smooth) * labels + 1.0 / n
    per = F.binary_cross_entropy_with_logits(logits, y, reduction="none")
    return (per * mask[:, None]).sum() / (mask.sum().clamp_min(1.0) * n)


def fault_mask(mask: torch.Tensor, fault: Optional[str]) -> torch.Tensor:
    """The batch's row mask, with the ``half_batch`` fault's second half of
    the rows left out."""
    if fault != "half_batch":
        return mask
    out = mask.clone()
    out[mask.shape[0] // 2:] = 0.0
    return out
