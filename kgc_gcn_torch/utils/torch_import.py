"""Import and export the reference implementation's PyTorch checkpoints (the
port's copy of ``kgc_gcn_tpu/utils/torch_import.py``).

The reference saves ``torch.save({'state_dict', 'optim_dict', 'measure'})``
to ``last.ckpt`` (reference utils.py:121-135), with the parameter names of
its ``MGCN``/``MGCNConv``/``ConvE`` (reference model.py:16-21, 56-68,
137-157).  Every tensor maps one to one onto the port's MGCN + ConvE under
the JAX leaf names (``models/mgcn.py``), except the per-edge table, which
also changes layout: the reference stores row i for edge id i, the port
stores it positionally in graph edge order (``data.graph.
edge_table_from_reference_order`` permutes it).  Two leaves are optional:
the conv bias ``conv1.bias`` (the port's ``conv.bias``, which only such a
checkpoint brings) and ConvE's ``conv2.conv_e.bias`` (``decoder.conv_b``).

The optimizer state is not imported: torch Adam moments have no mapping onto
the optax layout, and the reference restarts best tracking from the stored
measure (main.py:222-225).  Training from an imported checkpoint starts with
fresh moments.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from kgc_gcn_torch.data.graph import (
    Graph, edge_table_from_reference_order, edge_table_to_reference_order)

# reference name -> port (JAX leaf) name, for the tensors that map as they are
_DIRECT = {
    "entity_embedding": "entity_embedding",
    "relation_embedding": "relation_embedding",
    "conv1.in_weight": "conv.in_weight",
    "conv1.out_weight": "conv.out_weight",
    "conv1.loop_weight": "conv.loop_weight",
    "conv1.rels_weight": "conv.rels_weight",
    "conv1.loop_rel": "conv.loop_rel",
    "conv1.loop_edge": "conv.loop_edge",
    "conv2.conv_e.weight": "decoder.conv_w",
    "conv2.fc.weight": "decoder.fc_w",
    "conv2.fc.bias": "decoder.fc_b",
    "conv2.bias": "decoder.ent_bias",
}
_OPTIONAL = {"conv1.bias": "conv.bias", "conv2.conv_e.bias": "decoder.conv_b"}
# reference BatchNorm prefix -> port module prefix
_BNS = {"conv1.ent_bn": "conv.bn", "conv2.bn0": "decoder.bn0",
        "conv2.bn1": "decoder.bn1", "conv2.bn2": "decoder.bn2"}
_BN_LEAVES = (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
              ("running_var", "var"))


def _strip_module_prefix(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop the ``module.`` prefix DataParallel adds (reference main.py:213)."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def _arr(sd: Mapping[str, Any], key: str) -> np.ndarray:
    if key not in sd:
        raise KeyError(
            f"reference state_dict is missing '{key}' — is this an MGCN/ConvE "
            f"checkpoint? (got keys: {sorted(sd)[:8]}...)")
    v = sd[key]
    v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
    return np.asarray(v, dtype=np.float32)


def params_from_reference_state_dict(sd: Mapping[str, Any], graph: Graph
                                     ) -> Dict[str, torch.Tensor]:
    """Reference ``model.state_dict()`` (tensors or arrays) -> a state dict
    of the port's MGCN + ConvE (one layer), with ``conv.bias`` and
    ``decoder.conv_b`` only where the reference has them
    (``apply_reference_state_dict`` loads it)."""
    sd = _strip_module_prefix(sd)
    out = {ours: _arr(sd, ref) for ref, ours in _DIRECT.items()}
    out.update({ours: _arr(sd, ref) for ref, ours in _OPTIONAL.items()
                if ref in sd})
    out["edge_embeddings"] = edge_table_from_reference_order(
        _arr(sd, "edge_embeddings"), graph)
    for ref, ours in _BNS.items():
        for r_leaf, o_leaf in _BN_LEAVES:
            out[f"{ours}.{o_leaf}"] = _arr(sd, f"{ref}.{r_leaf}")
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}


def reference_state_dict_from_params(model, graph: Graph
                                     ) -> Dict[str, np.ndarray]:
    """The port's MGCN + ConvE -> a reference-compatible ``state_dict`` of
    numpy arrays, with the ``num_batches_tracked`` buffers that torch
    BatchNorm layers carry, so that it loads with ``strict=True`` into the
    reference model."""
    if type(model.decoder).__name__ != "ConvE":
        raise ValueError("only the ConvE decoder exists in the reference; "
                         f"cannot export {type(model.decoder).__name__}")
    sd = {k: v.detach().to("cpu", torch.float32).numpy()
          for k, v in model.state_dict().items()}
    out = {ref: sd[ours] for ref, ours in _DIRECT.items()}
    out.update({ref: sd[ours] for ref, ours in _OPTIONAL.items()
                if ours in sd})
    out["edge_embeddings"] = edge_table_to_reference_order(
        sd["edge_embeddings"], graph)
    for ref, ours in _BNS.items():
        for r_leaf, o_leaf in _BN_LEAVES:
            out[f"{ref}.{r_leaf}"] = sd[f"{ours}.{o_leaf}"]
        out[f"{ref}.num_batches_tracked"] = np.asarray(0, np.int64)
    return out


def read_reference_checkpoint(path: str) -> Tuple[Dict[str, Any], float]:
    """A reference ``last.ckpt`` (``torch.save`` file) -> (its state dict,
    without a ``module.`` prefix, and its measure).  Takes the full
    ``{'state_dict', ...}`` wrapper or a bare state dict; loads tensors
    only (``weights_only=True``)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    measure = float(blob.get("measure", 0.0)) if isinstance(blob, dict) else 0.0
    return _strip_module_prefix(sd), measure


def load_reference_checkpoint(path: str, graph: Graph
                              ) -> Tuple[Dict[str, torch.Tensor], float]:
    """A reference ``last.ckpt`` -> (the port's state dict, measure)."""
    sd, measure = read_reference_checkpoint(path)
    return params_from_reference_state_dict(sd, graph), measure


def apply_reference_state_dict(model, sd: Mapping[str, torch.Tensor]) -> None:
    """Load an imported state dict into an MGCN + ConvE model: the conv bias
    comes or goes with the checkpoint; ConvE's ``conv_b`` must already match
    it (build the model with ``cfg.bias`` set to whether the checkpoint has
    ``conv2.conv_e.bias``)."""
    if ("decoder.conv_b" in sd) != (model.decoder.conv_b is not None):
        raise ValueError("the model's ConvE conv bias (cfg.bias) must match "
                         "the reference checkpoint's conv2.conv_e.bias")
    model.conv.set_bias(sd.get("conv.bias"))
    model.load_state_dict(dict(sd))


def save_reference_checkpoint(path: str, model, graph: Graph,
                              measure: float = 0.0) -> None:
    """Write a reference-format ``last.ckpt`` of the port's MGCN + ConvE, so
    that its weights load back into the reference implementation
    (utils.py:138-155)."""
    sd = {k: torch.tensor(v) for k, v in
          reference_state_dict_from_params(model, graph).items()}
    torch.save({"state_dict": sd, "optim_dict": {}, "measure": measure}, path)
