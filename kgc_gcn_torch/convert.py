"""Weights carried between the JAX package and the port, both ways.

The port keeps the JAX parameter layout and names, so a JAX ``MGCNParams`` /
``MGCNState`` pair maps onto ``models.mgcn.MGCN``, an ``RGCNParams`` onto
``models.rgcn.RGCN`` and an ``RGATParams`` onto ``models.rgat.RGAT``, with
any decoder, by name alone, with no transposes.  Leaves travel
as numpy arrays keyed by their dotted JAX paths (``entity_embedding``,
``conv.in_weight``, ``conv.bias`` where a checkpoint brought MGCN's
optional conv bias, ``decoder.bn0.scale``, ``layers.0.basis``,
``layers.0.blocks`` in R-GCN's block mode,
``extra_convs.0.in_weight``, ``extra_edge_embeddings.0``; ``conv_bn.mean``,
``decoder.bn1.var``, ``extra_bn.0.var`` for the state).  The optimizer state
follows the parameters' order (``opt_state_leaves``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from kgc_gcn_torch.config import Config
from kgc_gcn_torch.train.optim import AdamState, moment_dtype


def _bn(prefix: str, leaves=("scale", "bias")) -> List[str]:
    return [f"{prefix}.{x}" for x in leaves]


_STATS = ("mean", "var")
_CONV = ("in_weight", "out_weight", "loop_weight", "rels_weight", "loop_rel",
         "loop_edge")


def _decoder_leaf_names(cfg: Config) -> Tuple[List[str], List[str]]:
    """The decoder's parameters and state: ConvE's BatchNorms, filters and
    fc layer, or the entity bias alone (DistMult, TransE, ComplEx, RotatE,
    whose state has no leaves)."""
    if cfg.decoder != "conve":
        return ["decoder.ent_bias"], []
    params = (_bn("decoder.bn0") + ["decoder.conv_w"]
              + (["decoder.conv_b"] if cfg.bias else [])
              + _bn("decoder.bn1") + ["decoder.fc_w", "decoder.fc_b"]
              + _bn("decoder.bn2") + ["decoder.ent_bias"])
    state = [n for k in range(3) for n in _bn(f"decoder.bn{k}", _STATS)]
    return params, state


def jax_leaf_names(cfg: Config, conv_bias: bool = False
                   ) -> Tuple[List[str], List[str]]:
    """Dotted paths of the JAX model's parameters and of its state, each in
    the order ``jax.tree.flatten`` lists them (dataclass field order; the
    ``None`` leaves, such as RGCN's ``blocks`` in basis mode, its ``basis``
    and ``coeff`` in block mode, or MGCN's conv ``bias``, drop out), for
    every family and decoder.  ``conv_bias`` lists MGCN's first conv bias,
    which only an imported reference checkpoint brings."""
    dec_params, dec_state = _decoder_leaf_names(cfg)
    depth = max(1, cfg.num_layers)
    rgcn = (("blocks", "self_weight") if cfg.num_blocks > 0
            else ("basis", "coeff", "self_weight"))
    layer_leaves = {"rgcn": rgcn,
                    "rgat": ("weight", "rel_mult", "att_src", "att_dst",
                             "rel_bias", "self_weight")}.get(cfg.model)
    if layer_leaves:
        layers = [f"layers.{i}.{w}" for i in range(depth)
                  for w in layer_leaves]
        return (["entity_embedding", "relation_embedding"] + layers
                + dec_params), dec_state
    conv = lambda p: [f"{p}.{w}" for w in _CONV] + _bn(f"{p}.bn")
    extra = range(depth - 1)
    params = (["entity_embedding", "relation_embedding", "edge_embeddings"]
              + conv("conv") + (["conv.bias"] if conv_bias else [])
              + dec_params
              + [n for i in extra for n in conv(f"extra_convs.{i}")]
              + [f"extra_edge_embeddings.{i}" for i in extra])
    state = (_bn("conv_bn", _STATS) + dec_state
             + [n for i in extra for n in _bn(f"extra_bn.{i}", _STATS)])
    return params, state


def _module_key(state_name: str) -> str:
    """JAX state path -> port state-dict key (``conv_bn.*`` are the buffers
    of ``conv.bn``, ``extra_bn.i.*`` those of ``extra_convs.i.bn``;
    ``decoder.bnK.*`` keep their names)."""
    if state_name.startswith("conv_bn."):
        return "conv.bn." + state_name[len("conv_bn."):]
    if state_name.startswith("extra_bn."):
        _, i, stat = state_name.split(".")
        return f"extra_convs.{i}.bn.{stat}"
    return state_name


def has_conv_bias(model) -> bool:
    """Whether an MGCN model holds the optional first conv bias."""
    conv = getattr(model, "conv", None)
    return getattr(conv, "bias", None) is not None


def model_leaf_names(model, cfg: Config) -> Tuple[List[str], List[str]]:
    """``jax_leaf_names`` of this model (with its conv bias, if any)."""
    return jax_leaf_names(cfg, has_conv_bias(model))


def model_params(model, cfg: Config) -> List[torch.Tensor]:
    """The model's parameters in JAX leaf order (the optimizer's order)."""
    return [model.get_parameter(name)
            for name in model_leaf_names(model, cfg)[0]]


def params_to_numpy(model, cfg: Config
                    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Inverse of ``params_from_numpy``: the model's parameters and BN
    statistics as ``{JAX path: float32 array}`` pairs, in JAX leaf order."""
    sd = model.state_dict()
    p_names, s_names = model_leaf_names(model, cfg)
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
