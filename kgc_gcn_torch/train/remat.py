"""``--remat``: the 1-vs-all trainer's encoder, recomputed in the backward
(the port's ``jax.checkpoint`` at ``kgc_gcn_tpu/train/loop.py:126-132``).

``checkpointed(encode, generators)`` runs ``encode()`` under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the forward keeps
none of the tensors the encoder's backward needs (its (N, d) activations,
dropout masks and BatchNorm inputs; the aggregations keep only their inputs
either way, ``ops/scatter.py:_Aggregate``), and the backward runs the encoder
a second time, through the same kernel wrappers, to make them again.
Reentrant checkpointing is refused by ``torch.autograd.grad``, which the
trainer differentiates with.

The recompute must be the forward's encoder to the bit, and leave the step's
state as one forward leaves it:
  * Generators.  Every dropout mask and edge sample draws from an explicit
    ``torch.Generator`` (``make_rngs``), which checkpoint's own
    ``preserve_rng_state`` does not cover (it saves the default generators,
    which the port never draws from, so it is off).  Each generator of the
    encoder's sites is saved before the forward; the recompute starts from
    that state and, when it ends, the generator gets back the state it had
    when the recompute began (after the decoder's draws, which may share
    it).  A generator only the decoder draws from (a data rank's stream)
    is not touched.
  * BatchNorm.  The recompute runs in ``frozen_running_stats``: the batch
    statistics normalize as in the forward, the running ones move once.
  * Collectives.  Under a mesh the recompute runs the forward's
    all-gathers, reduce-scatters, sums and ring sends again, inside the
    backward, in the same order on every rank.  Checkpoint's early stop
    (ending the recompute once the last saved tensor is made again) is off:
    every rank runs the whole encoder, so no rank can leave a collective of
    the encoder's tail unmatched.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from kgc_gcn_torch.models.common import frozen_running_stats


def checkpointed(encode: Callable[[], tuple],
                 generators: Iterable[torch.Generator]) -> tuple:
    """``encode()``'s outputs, its saved tensors recomputed in the backward
    from the states that ``generators`` have now."""
    gens = list({id(g): g for g in generators}.values())
    start = [g.get_state() for g in gens]

    @contextlib.contextmanager
    def recompute():
        resume = [g.get_state() for g in gens]
        for g, s in zip(gens, start):
            g.set_state(s)
        try:
            with frozen_running_stats():
                yield
        finally:
            for g, s in zip(gens, resume):
                g.set_state(s)

    with set_checkpoint_early_stop(False):
        return checkpoint(encode, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              recompute()))
