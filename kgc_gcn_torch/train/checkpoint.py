"""Checkpoints in the JAX package's two layouts, both ways.

``<dir>/last.ckpt`` is an npz of the flattened tree ``{"opt_state", "params",
"state"}`` (``kgc_gcn_tpu/train/checkpoint.py``): ``leaf_<i>`` arrays,
``leaf_<i>__dtype`` beside extended dtypes (bf16) stored as raw bits, and the
best validation measure under ``__measure__``.  Dict keys flatten in sorted
order, so the optimizer's leaves come first (``convert.opt_state_leaves``)
and the model's are the LAST ``len(params) + len(state)`` leaves, in the
order of ``convert.jax_leaf_names`` for the run's family (``cfg.model``).

``<dir>/last.orbax`` and ``<dir>/periodic.orbax`` are the same tree in
orbax's directory layout (``train/orbax_layout.py``), which the JAX package
writes where its tree is not fully addressable and for every periodic
checkpoint.  The port writes it where the JAX package does:

  * ``save_checkpoint``: ``last.orbax`` under a launcher with more than one
    rank, else ``last.ckpt``.  The policy is the reference's
    (utils.py:121-155): the trainer saves only when the validation MRR
    improves, so the checkpoint holds the best weights;
  * ``AsyncCheckpointer``: ``periodic.orbax`` on one device and on ranks,
    in the background.

On ranks each writes its own part: the ranks of data row 0 each their
graph slice's chunk of every per-edge table and of its two Adam moments
(graph rank g the chunk ``0.g.0``), rank 0 every replicated leaf, the
measure and the metadata.  All of it goes into ``<name>.tmp``; once every
rank has written (one collective over the world group, which also tells
each rank whether another failed), rank 0 renames it into place with a
rename aside (the old directory to ``.old``, ``.tmp`` to the name, ``.old``
removed), so that a crash never leaves the run without a loadable
checkpoint.

Either package reads what the other wrote, in either layout: the JAX
``load_checkpoint`` with a template from ``model.init`` and
``make_optimizer(cfg).init``, the port with numpy alone (orbax's OCDBT
default excepted, which it refuses).  A run directory gives ``last.orbax``
where it holds one, else ``last.ckpt``, as the JAX reader does.  Under a
mesh ``load_checkpoint`` returns the rank's slice of each per-edge table
and moment: from an orbax directory it reads only the chunks that overlap
the slice; another mesh or one device assembles what it needs.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from kgc_gcn_torch.config import Config
from kgc_gcn_torch.convert import (
    has_conv_bias, jax_leaf_names, model_leaf_names, module_key,
    opt_state_from_leaves, opt_state_leaves, params_from_numpy,
    params_to_numpy)
from kgc_gcn_torch.parallel.mesh import edge_slice, is_edge_table
from kgc_gcn_torch.train import orbax_layout as layout

CKPT_NAME = "last.ckpt"
ORBAX_NAME = "last.orbax"
PERIODIC_NAME = "periodic.orbax"
_MEASURE_KEY = "__measure__"


def _ckpt_path(path: str) -> str:
    """The checkpoint a path names: an npz file or an orbax directory, or
    in a run directory ``last.orbax`` before ``last.ckpt``."""
    if os.path.isdir(path) and not layout.is_layout(path):
        orbax = os.path.join(path, ORBAX_NAME)
        path = orbax if os.path.isdir(orbax) else os.path.join(path,
                                                                CKPT_NAME)
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    return path


def _leaf(data, i: int) -> torch.Tensor:
    arr = data[f"leaf_{i}"]
    tag = f"leaf_{i}__dtype"
    if tag in data.files:
        dtype = str(data[tag])
        if dtype != "bfloat16":
            raise ValueError(f"checkpoint leaf {i} has unsupported dtype {dtype}")
        # bf16 bits are the high half of the float32 with the same value
        return torch.from_numpy(np.ascontiguousarray(arr, np.uint16)
                                .view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _holds_conv_bias(cfg: Config, n_leaves: int) -> bool:
    """Whether a file of ``n_leaves`` leaves holds MGCN's optional first
    conv bias (a run trained on from an imported reference checkpoint):
    its tree, with or without the optimizer state, counts one parameter
    more than the config's."""
    if cfg.model != "mgcn":
        return False
    params, state = jax_leaf_names(cfg, conv_bias=True)
    return n_leaves in (len(params) + len(state),
                        1 + 3 * len(params) + len(state))


def _part(mesh) -> Optional[Tuple[int, int]]:
    """(graph rank, G) where the per-edge leaves are sliced, else None."""
    return None if mesh is None or mesh.graph == 1 else (mesh.graph_rank,
                                                         mesh.graph)


def _read_npz(path: str, cfg: Config, with_opt_state: bool, mesh):
    with np.load(path) as data:
        n_leaves = sum(1 for k in data.files
                       if k.startswith("leaf_") and not k.endswith("__dtype"))
        param_names, state_names = jax_leaf_names(
            cfg, _holds_conv_bias(cfg, n_leaves))
        names = param_names + state_names
        if n_leaves < len(names):
            raise ValueError(f"{path} holds {n_leaves} leaves; the model "
                             f"needs {len(names)}")
        first = n_leaves - len(names)
        leaves = {name: _leaf(data, first + i).float()
                  for i, name in enumerate(names)}
        measure = float(data[_MEASURE_KEY]) if _MEASURE_KEY in data.files else 0.0
        moments = None
        if with_opt_state:
            if first != 1 + 2 * len(param_names):
                raise ValueError(f"{path} holds {first} optimizer leaves; "
                                 f"Adam over {len(param_names)} parameters "
                                 f"needs {1 + 2 * len(param_names)}")
            moments = [_leaf(data, i) for i in range(first)]
    if mesh is not None and mesh.graph > 1:   # the rank's slices
        cut = lambda t: t[:, edge_slice(t.shape[1], mesh)].clone()
        leaves = {k: cut(v) if is_edge_table(k) else v
                  for k, v in leaves.items()}
        if moments is not None:
            p = len(param_names)
            moments = [cut(t) if i and is_edge_table(param_names[(i - 1) % p])
                       else t for i, t in enumerate(moments)]
    return param_names, state_names, leaves, measure, moments


def _read_orbax(path: str, cfg: Config, with_opt_state: bool, mesh):
    meta = layout.read_metadata(path)
    conv_bias = cfg.model == "mgcn" and layout.has_leaf(
        path, "tree.params.conv.bias")
    param_names, state_names = jax_leaf_names(cfg, conv_bias)
    part = _part(mesh)
    read = lambda name, jax_name: layout.read_leaf(
        path, name, part if is_edge_table(jax_name) else None)
    leaves = {n: read(f"tree.params.{n}", n).float() for n in param_names}
    leaves.update({n: read(f"tree.state.{n}", n).float()
                   for n in state_names})
    measure = float(layout.read_leaf(path, _MEASURE_KEY))
    moments = None
    if with_opt_state:
        adam = layout.adam_prefix(layout.node_keys(meta))
        moments = [layout.read_leaf(path, f"{adam}.count")] + [
            read(f"{adam}.{m}.{n}", n) for m in ("mu", "nu")
            for n in param_names]
    return param_names, state_names, leaves, measure, moments


def load_checkpoint(path: str, cfg: Config, with_opt_state: bool = False,
                    mesh=None):
    """Read a checkpoint: an npz file (``last.ckpt``), an orbax directory
    (``last.orbax``, ``periodic.orbax``) or the run directory that holds
    one of them.

    Returns (state dict for the model's ``load_state_dict``, stored
    measure), and with ``with_opt_state`` the optimizer's ``AdamState``
    third.  The state dict holds ``conv.bias`` where the file holds MGCN's
    optional first conv bias (``MGCNConv.set_bias`` gives a model one).
    With a ``mesh`` of G > 1 graph ranks each per-edge table and its
    moments are the rank's slice, the shapes of a model put on the mesh
    (``parallel.mesh.shard_params``)."""
    path = _ckpt_path(path)
    read = _read_orbax if os.path.isdir(path) else _read_npz
    param_names, state_names, leaves, measure, moments = read(
        path, cfg, with_opt_state, mesh)
    sd = params_from_numpy({k: leaves[k].numpy() for k in param_names},
                           {k: leaves[k].numpy() for k in state_names})
    if not with_opt_state:
        return sd, measure
    return sd, measure, opt_state_from_leaves(moments, cfg)


# ------------------------------------------------------------------ the npz

def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, Optional[str]]:
    """(array, dtype tag): bf16 travels as its raw bits, as the JAX writer
    stores extended dtypes."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def _npz_arrays(model, opt_state, cfg: Config, measure: float) -> dict:
    """The npz entries of one process's checkpoint, as host arrays."""
    params, state = params_to_numpy(model, cfg)
    leaves = ([_to_numpy(t) for t in opt_state_leaves(opt_state)]
              + [(a, None) for a in params.values()]
              + [(a, None) for a in state.values()])
    arrays = {}
    for i, (arr, tag) in enumerate(leaves):
        arrays[f"leaf_{i}"] = arr
        if tag is not None:
            arrays[f"leaf_{i}__dtype"] = np.asarray(tag)
    arrays[_MEASURE_KEY] = np.asarray(measure, np.float64)
    return arrays


def _mesh(model):
    """The grid the model was put on (``parallel.mesh.shard_params``)."""
    return getattr(model, "sharded_on", None)


def _ranks(mesh) -> int:
    return 1 if mesh is None else mesh.data * mesh.graph


# ---------------------------------------------------------------- the orbax

class _Plan:
    """One rank's part of an orbax checkpoint, as host bytes taken when it
    was made (so no later in-place update reaches it): ``chunks`` holds
    (leaf, chunk index, bytes); the lead rank's ``zarrays`` and ``meta``
    describe every leaf."""

    def __init__(self, model, opt_state, cfg: Config, measure: float, mesh):
        entries = layout.tree_entries(cfg, has_conv_bias(model))
        sd = model.state_dict()
        p_names, s_names = model_leaf_names(model, cfg)
        adam = layout.adam_prefix([e.keys for e in entries])
        tensors = {_MEASURE_KEY: (torch.tensor(measure, dtype=torch.float32),
                                  False),
                   f"{adam}.count": (torch.tensor(opt_state.count,
                                                  dtype=torch.int32), False)}
        for i, n in enumerate(p_names):
            edge = is_edge_table(n)
            tensors[f"tree.params.{n}"] = (sd[n], edge)
            tensors[f"{adam}.mu.{n}"] = (opt_state.mu[i], edge)
            tensors[f"{adam}.nu.{n}"] = (opt_state.nu[i], edge)
        for n in s_names:
            tensors[f"tree.state.{n}"] = (sd[module_key(n)], False)
        g, g_rank = ((1, 0) if mesh is None
                     else (mesh.graph, mesh.graph_rank))
        lead = mesh is None or mesh.rank == 0
        row0 = mesh is None or mesh.data_rank == 0
        self.chunks: List[Tuple[str, tuple, bytes]] = []
        self.zarrays, shapes = {}, {}
        self.edge_leaves = {k for k, (_, edge) in tensors.items() if edge}
        for e in entries:
            if e.kind != layout.ARRAY:
                continue
            t, edge = tensors[e.name]
            local = tuple(t.shape)
            shape, index = local, (0,) * t.dim()
            if edge and g > 1:
                shape = local[:1] + (local[1] * g,) + local[2:]
                index = (0, g_rank) + (0,) * (t.dim() - 2)
            shapes[e.name] = local
            if lead:
                self.zarrays[e.name] = layout.zarray(shape, local, t.dtype)
            if lead or (edge and g > 1 and row0):
                self.chunks.append((e.name, index,
                                    layout.chunk_bytes(t.detach().cpu())))
        self.meta = layout.metadata(entries, shapes) if lead else None


def _write_files(root: str, plan: _Plan, label: str) -> List[str]:
    """Write this rank's part of a checkpoint under ``root``; returns the
    files written (also logged)."""
    os.makedirs(root, exist_ok=True)
    written = []
    for name, doc in plan.zarrays.items():
        os.makedirs(os.path.join(root, name), exist_ok=True)
        layout.write_json(os.path.join(root, name, layout.ZARRAY), doc)
        written.append(os.path.join(name, layout.ZARRAY))
    edge = []
    for name, index, data in plan.chunks:
        written.append(layout.write_chunk(root, name, index, data))
        if name in plan.edge_leaves:
            edge.append(written[-1])
    if plan.meta is not None:
        layout.write_json(os.path.join(root, layout.METADATA), plan.meta)
        written.append(layout.METADATA)
    logging.info("checkpoint %s: this rank wrote %d files; per-edge chunks: "
                 "%s", label, len(written), ", ".join(sorted(edge)) or "none")
    return written


def _any(flag: bool, mesh) -> bool:
    """Whether any rank of the world raised ``flag``: a MAX over the
    world group, which also holds every rank until all have come."""
    if _ranks(mesh) == 1:
        return flag
    t = torch.tensor([float(flag)], device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _begin(tmp: str, mesh) -> None:
    """Rank 0 clears the temporary directory; the others wait for it."""
    if mesh is None or mesh.rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
    _any(False, mesh)


def _promote(tmp: str, final: str) -> None:
    """The rename aside: one loadable checkpoint exists at every instant
    (a crash between the two renames leaves the previous one at .old)."""
    old = final + ".old"
    shutil.rmtree(old, ignore_errors=True)
    if os.path.isdir(final):
        os.replace(final, old)
    os.replace(tmp, final)
    shutil.rmtree(old, ignore_errors=True)


def _commit(tmp: str, final: str, mesh,
            error: Optional[BaseException]) -> None:
    """After every rank has written its part: rank 0 promotes ``tmp``; a
    failure on any rank raises on every rank and promotes nothing."""
    if _any(error is not None, mesh):
        raise error or RuntimeError(f"{final}: another rank failed to write "
                                    "its part")
    if mesh is None or mesh.rank == 0:
        _promote(tmp, final)
    _any(False, mesh)   # in place before any rank returns


def save_checkpoint(ckpt_dir: str, model, opt_state, cfg: Config,
                    measure: float) -> str:
    """Write the best checkpoint atomically: ``<ckpt_dir>/last.orbax`` under
    a launcher with more than one rank (every rank calls it and writes its
    part), else ``<ckpt_dir>/last.ckpt`` (a temporary file, then
    ``os.replace``).  A crash never corrupts the previous checkpoint."""
    mesh = _mesh(model)
    if _ranks(mesh) > 1:
        final = os.path.join(ckpt_dir, ORBAX_NAME)
        tmp = final + ".tmp"
        plan = _Plan(model, opt_state, cfg, measure, mesh)
        _begin(tmp, mesh)
        error = None
        try:
            _write_files(tmp, plan, final)
        except Exception as e:   # raised on every rank by _commit
            error = e
        _commit(tmp, final, mesh, error)
        return final
    path = os.path.join(ckpt_dir, CKPT_NAME)
    arrays = _npz_arrays(model, opt_state, cfg, measure)
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


class AsyncCheckpointer:
    """Periodic checkpoints written in the background, at most one in
    flight (``checkpoint.py:save_checkpoint_async``,
    ``wait_for_async_checkpoints``), as ``periodic.orbax``.

    ``save_checkpoint_async`` first joins the previous write and promotes
    it, then takes a host copy of the leaves it writes before it returns,
    so that the optimizer's in-place updates of the next steps never reach
    the directory; a thread writes ``periodic.orbax.tmp``.  The next join
    promotes it with the rename aside, so that a loadable periodic
    checkpoint exists at every instant.  Under a mesh every rank calls
    both, at the same points, and writes its part."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._pending = None   # (tmp, final, mesh)
        self._error: Optional[BaseException] = None

    def save_checkpoint_async(self, ckpt_dir: str, model, opt_state,
                              cfg: Config, measure: float) -> str:
        self.wait_for_async_checkpoints()
        mesh = _mesh(model)
        path = os.path.join(ckpt_dir, PERIODIC_NAME)
        tmp = path + ".tmp"
        plan = _Plan(model, opt_state, cfg, measure, mesh)
        _begin(tmp, mesh)

        def write():
            try:
                _write_files(tmp, plan, path)
            except BaseException as e:   # re-raised by the next join
                self._error = e

        self._thread = threading.Thread(target=write, name="periodic-ckpt",
                                        daemon=True)
        self._thread.start()
        self._pending = (tmp, path, mesh)
        return path

    def wait_for_async_checkpoints(self) -> None:
        """Block until the write in flight has ended, and promote it."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        pending, self._pending = self._pending, None
        error, self._error = self._error, None
        if pending is None:
            if error is not None:
                raise error
            return
        tmp, final, mesh = pending
        _commit(tmp, final, mesh, error)
