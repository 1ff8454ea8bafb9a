"""Weights carried between the JAX package and the port, both ways.

The port keeps the JAX parameter layout and names, so a JAX ``MGCNParams`` /
``MGCNState`` pair maps onto ``models.mgcn.MGCN``, an ``RGCNParams`` onto
``models.rgcn.RGCN`` and an ``RGATParams`` onto ``models.rgat.RGAT``, by name
alone, with no transposes.  Leaves travel
as numpy arrays keyed by their dotted JAX paths (``entity_embedding``,
``conv.in_weight``, ``decoder.bn0.scale``, ``layers.0.basis``;
``conv_bn.mean``, ``decoder.bn1.var`` for the state).  The optimizer state
follows the parameters' order (``opt_state_leaves``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from kgc_gcn_torch.config import Config
from kgc_gcn_torch.train.optim import AdamState, moment_dtype


def jax_leaf_names(cfg: Config) -> Tuple[List[str], List[str]]:
    """Dotted paths of the JAX model's parameters and of its state, each in
    the order ``jax.tree.flatten`` lists them (dataclass field order; the
    ``None`` leaves, such as RGCN's ``blocks`` in basis mode, drop out).
    MGCN+ConvE, and RGCN+DistMult and RGAT+DistMult (which have no state)."""
    layer_leaves = {"rgcn": ("basis", "coeff", "self_weight"),
                    "rgat": ("weight", "rel_mult", "att_src", "att_dst",
                             "rel_bias", "self_weight")}.get(cfg.model)
    if layer_leaves:
        layers = [f"layers.{i}.{w}" for i in range(max(1, cfg.num_layers))
                  for w in layer_leaves]
        return (["entity_embedding", "relation_embedding"] + layers
                + ["decoder.ent_bias"]), []
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


def _module_key(state_name: str) -> str:
    """JAX state path -> port state-dict key (``conv_bn.*`` are the buffers
    of ``conv.bn``; ``decoder.bnK.*`` keep their names)."""
    return ("conv.bn." + state_name[len("conv_bn."):]
            if state_name.startswith("conv_bn.") else state_name)


def model_params(model, cfg: Config) -> List[torch.Tensor]:
    """The model's parameters in JAX leaf order (the optimizer's order)."""
    return [model.get_parameter(name) for name in jax_leaf_names(cfg)[0]]


def params_to_numpy(model, cfg: Config
                    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Inverse of ``params_from_numpy``: the model's parameters and BN
    statistics as ``{JAX path: float32 array}`` pairs, in JAX leaf order."""
    sd = model.state_dict()
    p_names, s_names = jax_leaf_names(cfg)
    arr = lambda t: t.detach().to("cpu", torch.float32).numpy()
    return ({n: arr(sd[n]) for n in p_names},
            {n: arr(sd[_module_key(n)]) for n in s_names})


def opt_state_leaves(state) -> List[torch.Tensor]:
    """The optimizer state as optax's chain state flattens: the clip and
    decay states have no leaves, then Adam's ``count`` (an int32 scalar),
    the ``mu`` leaves and the ``nu`` leaves, each in parameter order; CPU
    tensors in the moments' dtype (float32 or bf16)."""
    return ([torch.tensor(state.count, dtype=torch.int32)]
            + [t.detach().cpu() for t in state.mu]
            + [t.detach().cpu() for t in state.nu])


def opt_state_from_leaves(leaves: List[torch.Tensor], cfg: Config):
    """Inverse of ``opt_state_leaves``; moments in ``cfg.moment_dtype``."""
    n = (len(leaves) - 1) // 2
    dtype = moment_dtype(cfg)
    return AdamState(int(leaves[0]), [t.to(dtype) for t in leaves[1:1 + n]],
                     [t.to(dtype) for t in leaves[1 + n:]])


def params_from_numpy(params: Dict[str, np.ndarray],
                      state: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX params + state leaves -> a state dict for the model's
    ``load_state_dict``.

    Parameter paths are the module's names; the state's ``conv_bn.*`` are
    the buffers of ``conv.bn`` and ``decoder.bnK.*`` keep their names."""
    out = {}
    for name, arr in params.items():
        out[name] = torch.from_numpy(np.array(arr, np.float32))
    for name, arr in state.items():
        out[_module_key(name)] = torch.from_numpy(np.array(arr, np.float32))
    return out
