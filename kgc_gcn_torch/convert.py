"""Weights carried across from the JAX package.

The port keeps the JAX parameter layout and names, so a JAX ``MGCNParams`` /
``MGCNState`` pair maps onto ``models.mgcn.MGCN`` by name alone, with no
transposes.  Leaves arrive as numpy arrays keyed by their dotted JAX paths
(``entity_embedding``, ``conv.in_weight``, ``decoder.bn0.scale``;
``conv_bn.mean``, ``decoder.bn1.var`` for the state).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from kgc_gcn_torch.config import Config


def jax_leaf_names(cfg: Config) -> Tuple[List[str], List[str]]:
    """Dotted paths of the JAX MGCN+ConvE parameters and of its state, each
    in the order ``jax.tree.flatten`` lists them (dataclass field order)."""
    bn = lambda p, leaves=("scale", "bias"): [f"{p}.{x}" for x in leaves]
    params = (["entity_embedding", "relation_embedding", "edge_embeddings"]
              + [f"conv.{w}" for w in ("in_weight", "out_weight", "loop_weight",
                                       "rels_weight", "loop_rel", "loop_edge")]
              + bn("conv.bn") + bn("decoder.bn0") + ["decoder.conv_w"]
              + (["decoder.conv_b"] if cfg.bias else [])
              + bn("decoder.bn1") + ["decoder.fc_w", "decoder.fc_b"]
              + bn("decoder.bn2") + ["decoder.ent_bias"])
    stats = ("mean", "var")
    state = (bn("conv_bn", stats) + bn("decoder.bn0", stats)
             + bn("decoder.bn1", stats) + bn("decoder.bn2", stats))
    return params, state


def params_from_numpy(params: Dict[str, np.ndarray],
                      state: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX params + state leaves -> a state dict for ``MGCN.load_state_dict``.

    Parameter paths are the module's names; the state's ``conv_bn.*`` are
    the buffers of ``conv.bn`` and ``decoder.bnK.*`` keep their names."""
    out = {}
    for name, arr in params.items():
        out[name] = torch.from_numpy(np.array(arr, np.float32))
    for name, arr in state.items():
        key = "conv.bn." + name[len("conv_bn."):] \
            if name.startswith("conv_bn.") else name
        out[key] = torch.from_numpy(np.array(arr, np.float32))
    return out
