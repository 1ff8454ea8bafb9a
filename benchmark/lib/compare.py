"""The numbers that decide ``correct``, and the decision.

Training (each step's loss, each leaf's first clipped gradient, each leaf's
change after the checked steps, program against the reference in
float64).  Each leaf's gap is the gap between the two norms, against the
reference's norm of that leaf or of the median leaf, whichever is larger.  Every training run reads
six numbers:

  * ``loss_gap_any_step``: the worst step's |loss_prog - loss_ref| /
    |loss_ref|; ``loss_gap_step1``: the first step's;
  * ``grad_gap_worst_leaf``, ``grad_gap_median_leaf``: the worst and the
    median leaf's gap of the first gradient;
  * ``change_gap_worst_leaf``, ``change_gap_median_leaf``: the same of the
    change, over the leaves whose reference gradient is at least a
    thousandth of the median leaf's (a leaf below that, such as a scale
    that BatchNorm cancels, moves under Adam by round-off alone).

A cell's limits file (``limits/<cell>.json``) names the numbers that are
compared.  Step 1's loss is a forward pass and well conditioned: it parts
float32 from TF32.  The worst step and the worst leaf see a fault confined
to a few leaves (a wrong d_x reaches the entity table alone), but on some
seeds they carry the problem's own ill-conditioning: gradients that
BatchNorm's backward forms from sums which cancel move by 1e-3 of a leaf
between two float32 computations, or between float32 and float64, so
their limits sit above that and catch gross faults.  The rest go to
standard error beside them.

Evaluation (every answer of the window, each a filtered rank):

  * ``rank_gap``: the largest shift of a target's reference score, in units
    of its row's score spread, that makes the program's rank the
    reference's (``reference/common.py:rank_gaps``);
  * ``metric_gap``: the largest difference between a metric the program
    reported and that metric worked out from the program's own ranks;
  * ``answers_missing``: answers due in the window that never came.

``correct`` needs every number that the cell's limits name to be there and
at most its limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

GRAD_FLOOR = 1e-3     # of the median leaf's reference gradient norm


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keys) -> Dict[str, float]:
    """Each leaf's gap of norms against the larger of its reference norm
    and the median leaf's."""
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    gaps = {}
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        gaps[k] = gap if math.isfinite(gap) else math.inf
    return gaps


def moved_leaves(ref_grad: Dict[str, float]):
    med = statistics.median(ref_grad.values())
    return [k for k, g in ref_grad.items() if g >= GRAD_FLOOR * med]


def _finite(v: float) -> float:
    return v if math.isfinite(v) else math.inf


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """Every training number (see the module's docstring)."""
    losses = [_finite(abs(p - r) / max(abs(r), 1e-30))
              for p, r in zip(prog["loss"], ref["loss"])]
    if len(prog["loss"]) != len(ref["loss"]):
        losses = [math.inf]
    grad = leaf_gaps(prog["grad"], ref["grad"], ref["grad"])
    change = leaf_gaps(prog["change"], ref["change"],
                       moved_leaves(ref["grad"]))
    return {"loss_gap_step1": losses[0],
            "loss_gap_any_step": max(losses),
            "grad_gap_median_leaf": statistics.median(grad.values()),
            "grad_gap_worst_leaf": max(grad.values()),
            "change_gap_median_leaf": statistics.median(change.values()),
            "change_gap_worst_leaf": max(change.values())}


def train_detail(prog: dict, ref: dict) -> str:
    """Every step's loss and the three leaves of largest gap of each norm,
    for standard error."""
    top = lambda gaps: ", ".join(f"{k} {v:.3g}" for k, v in sorted(
        gaps.items(), key=lambda kv: -kv[1])[:3])
    return (f"losses {prog['loss']} reference {ref['loss']}; grad gaps: "
            + top(leaf_gaps(prog["grad"], ref["grad"], ref["grad"]))
            + "; change gaps: "
            + top(leaf_gaps(prog["change"], ref["change"],
                            moved_leaves(ref["grad"]))))


def decide(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that ``limits`` names there and at most its limit (NaN
    fails); no limits, no decision."""
    return bool(limits) and all(k in numbers and numbers[k] <= v
                                for k, v in limits.items())


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """``{name: {"value", "limit"}}`` of the compared numbers, for the
    result's last key (a missing number reads inf)."""
    return {k: {"value": numbers.get(k, math.inf), "limit": v}
            for k, v in limits.items()}
