"""Checkpoints in orbax's directory layout, written and read with ``json``
and numpy alone (the card has neither orbax nor tensorstore).

The JAX package saves a tree that is not fully addressable (any run of
more than one process) with ``orbax.checkpoint.StandardCheckpointer``, and
its periodic checkpoints always so (``kgc_gcn_tpu/train/checkpoint.py``).
Its restore, ``StandardCheckpointer().restore(path, template)``, reads any
directory of this plain layout:

  * one zarr-v2 directory per array leaf, named by the leaf's dotted key
    path (``tree.params.conv.in_weight``), holding a ``.zarray`` JSON
    (``compressor: null``, C order, little-endian ``<f4`` / ``<i4``, or
    ``bfloat16`` as orbax names it) and one file per chunk, named by the
    chunk's index along each axis (``0.0``; ``0`` for a scalar).  Each
    per-edge leaf ``(2, E_pad, d)`` is chunked along the edges at the
    graph slices, ``(2, E_pad/G, d)``: graph rank g's chunk is ``0.g.0``;
  * ``_METADATA``: ``use_ocdbt: false``, ``use_zarr3: false`` and one entry
    per node of the tree, keyed by the tuple of its keys (``key_type`` 2
    for a dict key or a dataclass field, 1 for a sequence index), the
    ``None`` leaves and empty tuples included (orbax rebuilds the tree's
    sequences from them).  Orbax's other side files (``_sharding``,
    ``_CHECKPOINT_METADATA``, ``array_metadatas/``) are not needed by its
    restore and are not written.

``tree_entries`` lists the tree of the JAX CLI's checkpoint,
``{"__measure__", "tree": {"opt_state", "params", "state"}}``
(``kgc_gcn_tpu/cli.py:394-396``), with the key paths orbax gives each
family's dataclass and optax nodes: the table that
``tests/test_torch_orbax_layout.py`` pins against the JAX package's own
writer.  Orbax's default writes OCDBT (a key-value store in B-tree files),
which nothing on the card reads: such a directory is refused.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kgc_gcn_torch.config import Config

METADATA = "_METADATA"
MEASURE = "__measure__"
ZARRAY = ".zarray"

# the nodes of the tree: an array leaf, a None leaf, an empty tuple
ARRAY, NONE, EMPTY = "array", "none", "tuple"
_KEY_DICT, _KEY_SEQ = 2, 1

_VALUE_META = {NONE: {"value_type": "None", "skip_deserialize": True},
               EMPTY: {"value_type": "Tuple", "skip_deserialize": True}}

_TO_ZARR = {torch.float32: "<f4", torch.int32: "<i4",
            torch.bfloat16: "bfloat16"}

REFUSED = ("{path}: {what}.  The JAX package wrote it with orbax's default "
           "(OCDBT, compressed chunks), which the card has no reader for; "
           "save it with the JAX package's npz backend "
           "(kgc_gcn_tpu.train.checkpoint.save_checkpoint(..., "
           "backend='npz')) to carry it across")


@dataclass(frozen=True)
class Entry:
    """One node of the checkpoint's tree: its keys from the root, each
    key's type, and its kind (``ARRAY``, ``NONE`` or ``EMPTY``)."""
    keys: Tuple[str, ...]
    types: Tuple[int, ...]
    kind: str

    @property
    def name(self) -> str:
        """Orbax's parameter name: the leaf's directory."""
        return ".".join(self.keys)


# ------------------------------------------------------------ the key table

def _bn(*leaves):
    return dict.fromkeys(leaves, ARRAY)


def _decoder(cfg: Config):
    """(params, state) of the decoder: ConvE's fields in dataclass order,
    or the entity bias alone (its state then a None leaf)."""
    if cfg.decoder != "conve":
        return {"ent_bias": ARRAY}, NONE
    bn, stats = _bn("scale", "bias"), _bn("mean", "var")
    params = {"bn0": bn, "conv_w": ARRAY,
              "conv_b": ARRAY if cfg.bias else NONE, "bn1": bn,
              "fc_w": ARRAY, "fc_b": ARRAY, "bn2": bn, "ent_bias": ARRAY}
    return params, {"bn0": stats, "bn1": stats, "bn2": stats}


def _conv(bias: bool) -> dict:
    return {**_bn("in_weight", "out_weight", "loop_weight", "rels_weight",
                  "loop_rel", "loop_edge"),
            "bn": _bn("scale", "bias"), "bias": ARRAY if bias else NONE}


def _family(cfg: Config, conv_bias: bool):
    """(params, state) of the model family, as nested dicts (dataclass
    fields) and lists (sequences); an empty sequence is an ``EMPTY``."""
    dec_params, dec_state = _decoder(cfg)
    depth = max(1, cfg.num_layers)
    seq = lambda items: list(items) or EMPTY
    embeddings = _bn("entity_embedding", "relation_embedding")
    if cfg.model == "mgcn":
        extra = range(depth - 1)
        params = {**embeddings, "edge_embeddings": ARRAY,
                  "conv": _conv(conv_bias), "decoder": dec_params,
                  "extra_convs": seq(_conv(False) for _ in extra),
                  "extra_edge_embeddings": seq(ARRAY for _ in extra)}
        state = {"conv_bn": _bn("mean", "var"), "decoder": dec_state,
                 "extra_bn": seq(_bn("mean", "var") for _ in extra)}
        return params, state
    if cfg.model == "rgcn":
        block = cfg.num_blocks > 0
        layer = {"basis": NONE if block else ARRAY,
                 "coeff": NONE if block else ARRAY,
                 "blocks": ARRAY if block else NONE, "self_weight": ARRAY}
    else:
        layer = _bn("weight", "rel_mult", "att_src", "att_dst", "rel_bias",
                    "self_weight")
    params = {**embeddings, "layers": [dict(layer) for _ in range(depth)],
              "decoder": dec_params}
    return params, {"decoder": dec_state}


def _walk(node, keys=(), types=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _walk(v, keys + (k,), types + (_KEY_DICT,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _walk(v, keys + (str(i),), types + (_KEY_SEQ,))
    else:
        yield Entry(keys, types, node)


def tree_entries(cfg: Config, conv_bias: bool = False) -> List[Entry]:
    """Every node of the checkpoint tree that orbax records, in the order
    ``jax.tree.flatten`` gives it: the measure, then the optimizer's chain
    (a None leaf for the clip and for weight decay where they are on,
    then Adam's ``count``, ``mu`` and ``nu``, the moments shaped as the
    parameters), the parameters and the state.  The array leaves of
    ``params`` and ``state`` are ``convert.jax_leaf_names`` in order."""
    params, state = _family(cfg, conv_bias)
    chain = ([NONE] * (cfg.clip_grad > 0) + [NONE] * (cfg.weight_decay > 0)
             + [{"count": ARRAY, "mu": params, "nu": params}])
    tree = {MEASURE: ARRAY,
            "tree": {"opt_state": chain, "params": params, "state": state}}
    return list(_walk(tree))


def adam_prefix(keys: Sequence[Tuple[str, ...]]) -> str:
    """``tree.opt_state.<i>``, the optimizer chain's Adam state, among the
    key paths of a tree's nodes."""
    counts = [k for k in keys if k[:2] == ("tree", "opt_state")
              and k[-1] == "count"]
    if len(counts) != 1:
        raise ValueError(f"{len(counts)} Adam states in the checkpoint")
    return ".".join(counts[0][:-1])


def node_keys(meta: dict) -> List[Tuple[str, ...]]:
    """The key paths of the nodes a ``_METADATA`` document records."""
    return [tuple(k["key"] for k in m["key_metadata"])
            for m in meta["tree_metadata"].values()]


def metadata(entries: Sequence[Entry],
             write_shapes: Dict[str, Sequence[int]]) -> dict:
    """The ``_METADATA`` document: each array's ``write_shape`` is the
    chunk a process writes (``write_shapes`` by entry name)."""
    tree = {}
    for e in entries:
        if e.kind != ARRAY:
            value = dict(_VALUE_META[e.kind])
        elif e.keys == (MEASURE,):
            value = {"value_type": "np.ndarray", "skip_deserialize": False}
        else:
            value = {"value_type": "jax.Array", "skip_deserialize": False,
                     "write_shape": list(write_shapes[e.name])}
        tree[str(e.keys)] = {
            "key_metadata": [{"key": k, "key_type": t}
                             for k, t in zip(e.keys, e.types)],
            "value_metadata": value}
    return {"tree_metadata": tree, "use_ocdbt": False, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}


# ----------------------------------------------------------------- writing

def chunk_key(index: Sequence[int]) -> str:
    return ".".join(str(i) for i in index) or "0"


def zarray(shape: Sequence[int], chunks: Sequence[int], dtype) -> dict:
    """A leaf's ``.zarray``: uncompressed, C order."""
    return {"chunks": list(chunks), "compressor": None,
            "dimension_separator": ".", "dtype": _TO_ZARR[dtype],
            "fill_value": None, "filters": None, "order": "C",
            "shape": list(shape), "zarr_format": 2}


def chunk_bytes(t: torch.Tensor) -> bytes:
    """A host tensor's little-endian C-order bytes (bf16 as its bits)."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().astype("<i2").tobytes()
    return t.numpy().astype(_TO_ZARR[t.dtype]).tobytes()


def write_json(path: str, doc: dict) -> None:
    with open(path, "w") as f:
        json.dump(doc, f)


def write_chunk(root: str, name: str, index: Sequence[int],
                data: bytes) -> str:
    """One chunk file of leaf ``name``; returns its path under ``root``."""
    os.makedirs(os.path.join(root, name), exist_ok=True)
    rel = os.path.join(name, chunk_key(index))
    with open(os.path.join(root, rel), "wb") as f:
        f.write(data)
    return rel


# ----------------------------------------------------------------- reading

def is_layout(path: str) -> bool:
    """Whether ``path`` is an orbax checkpoint directory."""
    return os.path.isfile(os.path.join(path, METADATA))


def read_metadata(path: str) -> dict:
    """The ``_METADATA`` of a directory in the plain layout; OCDBT is
    refused."""
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    if meta.get("use_ocdbt", True) or meta.get("use_zarr3", False):
        raise ValueError(REFUSED.format(
            path=path, what="an OCDBT (or zarr3) orbax checkpoint"))
    return meta


def has_leaf(path: str, name: str) -> bool:
    return os.path.isfile(os.path.join(path, name, ZARRAY))


def read_leaf(path: str, name: str,
              part: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Leaf ``name`` as a CPU tensor, or with ``part = (g, G)`` the g-th of
    G equal slices along axis 1 (a per-edge leaf's edges: graph rank g's),
    read from the chunks that overlap it only: on the mesh that wrote it,
    the rank's own chunk."""
    with open(os.path.join(path, name, ZARRAY)) as f:
        za = json.load(f)
    if za.get("compressor") is not None or za.get("filters"):
        raise ValueError(REFUSED.format(path=f"{path}/{name}",
                                        what="a compressed zarr leaf"))
    if za.get("order", "C") != "C" or za.get("zarr_format") != 2:
        raise ValueError(f"{path}/{name}: not a C-order zarr-v2 leaf")
    bf16 = za["dtype"] == "bfloat16"
    dtype = np.dtype("<i2") if bf16 else np.dtype(za["dtype"])
    shape, chunks = tuple(za["shape"]), tuple(za["chunks"])
    if part is None:
        lo, hi, want = 0, 0, shape
    else:
        step = shape[1] // part[1]
        lo, hi = part[0] * step, (part[0] + 1) * step
        want = shape[:1] + (step,) + shape[2:]
    out = np.empty(want, dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    if part is not None:
        grid[1] = range(lo // chunks[1], -(-hi // chunks[1]))
    for index in np.ndindex(*[len(g) for g in grid]):
        index = tuple(g[i] for g, i in zip(grid, index))
        file = os.path.join(path, name, chunk_key(index))
        if not os.path.isfile(file):
            raise FileNotFoundError(f"{file}: a chunk is missing (a rank "
                                    "did not write it)")
        block = np.fromfile(file, dtype).reshape(chunks)
        src, dst = [], []
        for ax, (i, c, s) in enumerate(zip(index, chunks, shape)):
            a, b = i * c, min((i + 1) * c, s)
            if ax == 1 and part is not None:
                a, b = max(a, lo), min(b, hi)
                dst.append(slice(a - lo, b - lo))
            else:
                dst.append(slice(a, b))
            src.append(slice(a - i * c, b - i * c))
        out[tuple(dst)] = block[tuple(src)]
    t = torch.from_numpy(out.astype(out.dtype.newbyteorder("=")))
    return t.view(torch.bfloat16) if bf16 else t
