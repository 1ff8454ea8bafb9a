"""Checkpoints, read side: serve a model that the JAX package trained.

The JAX package writes ``<dir>/last.ckpt`` as an npz of the flattened tree
``{"params", "state", "opt_state"}`` (``kgc_gcn_tpu/train/checkpoint.py``):
``leaf_<i>`` arrays, ``leaf_<i>__dtype`` beside extended dtypes stored as raw
bits, and the best validation measure under ``__measure__``.  Dict keys
flatten in sorted order, so the optimizer's leaves come first and the model's
are the LAST ``len(params) + len(state)`` leaves, in the order of
``convert.jax_leaf_names``.  Reading needs numpy alone.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from kgc_gcn_torch.config import Config
from kgc_gcn_torch.convert import jax_leaf_names, params_from_numpy

CKPT_NAME = "last.ckpt"
_MEASURE_KEY = "__measure__"


def _leaf(data, i: int) -> np.ndarray:
    arr = data[f"leaf_{i}"]
    tag = f"leaf_{i}__dtype"
    if tag in data.files:
        dtype = str(data[tag])
        if dtype != "bfloat16":
            raise ValueError(f"checkpoint leaf {i} has unsupported dtype {dtype}")
        # bf16 bits are the high half of the float32 with the same value
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


def load_jax_checkpoint(path: str, cfg: Config
                        ) -> Tuple[Dict[str, torch.Tensor], float]:
    """(state dict for ``MGCN.load_state_dict``, stored measure) from a JAX
    npz checkpoint file or the run directory that holds ``last.ckpt``."""
    if os.path.isdir(path):
        if os.path.isdir(os.path.join(path, "last.orbax")):
            raise NotImplementedError(
                "orbax checkpoints are not readable by kgc_gcn_torch; "
                "save with the JAX package's npz backend")
        path = os.path.join(path, CKPT_NAME)
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    with np.load(path) as data:
        n_leaves = sum(1 for k in data.files
                       if k.startswith("leaf_") and not k.endswith("__dtype"))
        param_names, state_names = jax_leaf_names(cfg)
        names = param_names + state_names
        if n_leaves < len(names):
            raise ValueError(f"{path} holds {n_leaves} leaves; the model "
                             f"needs {len(names)}")
        first = n_leaves - len(names)
        leaves = {name: _leaf(data, first + i) for i, name in enumerate(names)}
        measure = float(data[_MEASURE_KEY]) if _MEASURE_KEY in data.files else 0.0
    return params_from_numpy({k: leaves[k] for k in param_names},
                             {k: leaves[k] for k in state_names}), measure
