"""Checkpoints in the JAX package's npz format, both ways.

``<dir>/last.ckpt`` is an npz of the flattened tree ``{"opt_state", "params",
"state"}`` (``kgc_gcn_tpu/train/checkpoint.py``): ``leaf_<i>`` arrays,
``leaf_<i>__dtype`` beside extended dtypes (bf16) stored as raw bits, and the
best validation measure under ``__measure__``.  Dict keys flatten in sorted
order, so the optimizer's leaves come first (``convert.opt_state_leaves``)
and the model's are the LAST ``len(params) + len(state)`` leaves, in the
order of ``convert.jax_leaf_names`` for the run's family (``cfg.model``).
Either package reads what the other wrote: the JAX ``load_checkpoint`` with
a template from ``model.init`` and ``make_optimizer(cfg).init``, the port
with numpy alone.  The policy is the
reference's (utils.py:121-155): the trainer saves only when the validation
MRR improves, so ``last.ckpt`` holds the best weights.

Under a mesh (``parallel/mesh.py``) the file keeps the single-device layout:
every rank takes part in gathering the per-edge tables and their moments
over its graph group, and rank 0 writes.  On restore every rank reads the
whole file and takes its slice, so a run under a mesh restores on one
device and the reverse.  (The JAX package writes orbax where its arrays are
not fully addressable, ``kgc_gcn_tpu/train/checkpoint.py:54-55``.)
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from kgc_gcn_torch.config import Config
from kgc_gcn_torch.convert import (
    jax_leaf_names, model_leaf_names, opt_state_from_leaves, opt_state_leaves,
    params_from_numpy, params_to_numpy)
from kgc_gcn_torch.parallel.distributed import all_gather_cat
from kgc_gcn_torch.parallel.mesh import edge_table_names

CKPT_NAME = "last.ckpt"
PERIODIC_NAME = "periodic.ckpt"
_MEASURE_KEY = "__measure__"


def _ckpt_path(path: str) -> str:
    if os.path.isdir(path):
        if os.path.isdir(os.path.join(path, "last.orbax")):
            raise NotImplementedError(
                "orbax checkpoints are not readable by kgc_gcn_torch; "
                "save with the JAX package's npz backend")
        path = os.path.join(path, CKPT_NAME)
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


def load_checkpoint(path: str, cfg: Config, with_opt_state: bool = False):
    """Read a checkpoint file (``last.ckpt`` or ``periodic.ckpt``), or the
    run directory that holds ``last.ckpt``.

    Returns (state dict for the model's ``load_state_dict``, stored
    measure), and with ``with_opt_state`` the optimizer's ``AdamState``
    third.  The state dict holds ``conv.bias`` where the file holds MGCN's
    optional first conv bias (``MGCNConv.set_bias`` gives a model one)."""
    path = _ckpt_path(path)
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
        leaves = {name: _leaf(data, first + i).float().numpy()
                  for i, name in enumerate(names)}
        measure = float(data[_MEASURE_KEY]) if _MEASURE_KEY in data.files else 0.0
        opt = None
        if with_opt_state:
            if first != 1 + 2 * len(param_names):
                raise ValueError(f"{path} holds {first} optimizer leaves; "
                                 f"Adam over {len(param_names)} parameters "
                                 f"needs {1 + 2 * len(param_names)}")
            opt = opt_state_from_leaves([_leaf(data, i) for i in range(first)],
                                        cfg)
    sd = params_from_numpy({k: leaves[k] for k in param_names},
                           {k: leaves[k] for k in state_names})
    return (sd, measure, opt) if with_opt_state else (sd, measure)


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, Optional[str]]:
    """(array, dtype tag): bf16 travels as its raw bits, as the JAX writer
    stores extended dtypes."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def _gather_edge_tables(model, opt_state, cfg: Config, mesh, params: dict,
                        opt: list) -> None:
    """Replace each per-edge table's slice in ``params`` and ``opt`` (the
    leaves of ``opt_state_leaves``) by the whole table, gathered over the
    graph group (a collective: every rank calls it)."""
    if mesh is None or mesh.graph == 1:
        return
    names = model_leaf_names(model, cfg)[0]
    whole = lambda t: all_gather_cat(t.detach().float(), mesh.graph_group, 1)
    for name in edge_table_names(model):
        i = names.index(name)
        params[name] = whole(model.get_parameter(name)).cpu().numpy()
        for j, moments in ((1 + i, opt_state.mu),
                           (1 + len(names) + i, opt_state.nu)):
            opt[j] = whole(moments[i]).to(moments[i].dtype).cpu()


def _mesh(model):
    """The grid the model was put on (``parallel.mesh.shard_params``)."""
    return getattr(model, "sharded_on", None)


def _checkpoint_arrays(model, opt_state, cfg: Config, measure: float,
                       copy: bool = False) -> dict:
    """The npz entries of one checkpoint, as host arrays; ``copy`` makes
    every array its own copy, so that no later in-place update of a CPU
    parameter or moment reaches it.  Under a mesh the per-edge tables are
    gathered whole on every rank."""
    params, state = params_to_numpy(model, cfg)
    opt = opt_state_leaves(opt_state)
    _gather_edge_tables(model, opt_state, cfg, _mesh(model), params, opt)
    leaves = ([_to_numpy(t) for t in opt]
              + [(a, None) for a in params.values()]
              + [(a, None) for a in state.values()])
    arrays = {}
    for i, (arr, tag) in enumerate(leaves):
        arrays[f"leaf_{i}"] = np.array(arr, copy=True) if copy else arr
        if tag is not None:
            arrays[f"leaf_{i}__dtype"] = np.asarray(tag)
    arrays[_MEASURE_KEY] = np.asarray(measure, np.float64)
    return arrays


def _write_npz(path: str, arrays: dict) -> None:
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def _writes(mesh) -> bool:
    return mesh is None or mesh.rank == 0


def save_checkpoint(ckpt_dir: str, model, opt_state, cfg: Config,
                    measure: float) -> str:
    """Write ``<ckpt_dir>/last.ckpt`` atomically (write a temporary file,
    then ``os.replace``): a crash never corrupts the previous checkpoint.
    Under a mesh every rank calls it and rank 0 writes."""
    path = os.path.join(ckpt_dir, CKPT_NAME)
    arrays = _checkpoint_arrays(model, opt_state, cfg, measure)
    if _writes(_mesh(model)):
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = path + ".tmp"
        _write_npz(tmp, arrays)
        os.replace(tmp, path)
    return path


class AsyncCheckpointer:
    """Periodic checkpoints written in the background, at most one in
    flight (``checkpoint.py:save_checkpoint_async``,
    ``wait_for_async_checkpoints``).

    ``save_checkpoint_async`` first joins the previous write and promotes
    it, then takes a host copy of every leaf before it returns, so that the
    optimizer's in-place updates of the next steps never reach the file;
    the thread writes ``periodic.ckpt.tmp``.  The next join promotes it
    with a rename aside (old file to ``.old``, tmp file to
    ``periodic.ckpt``, then ``.old`` removed), so that a loadable periodic
    checkpoint exists at every instant."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._pending: Optional[Tuple[str, str]] = None   # (tmp, final)
        self._error: Optional[BaseException] = None

    def save_checkpoint_async(self, ckpt_dir: str, model, opt_state,
                              cfg: Config, measure: float) -> str:
        """Under a mesh every rank calls it (the gather) and rank 0
        writes."""
        self.wait_for_async_checkpoints()
        path = os.path.join(ckpt_dir, PERIODIC_NAME)
        tmp = path + ".tmp"
        arrays = _checkpoint_arrays(model, opt_state, cfg, measure, copy=True)
        if not _writes(_mesh(model)):
            return path
        os.makedirs(ckpt_dir, exist_ok=True)

        def write():
            try:
                _write_npz(tmp, arrays)
            except BaseException as e:   # re-raised by the next join
                self._error = e

        self._thread = threading.Thread(target=write, name="periodic-ckpt",
                                        daemon=True)
        self._thread.start()
        self._pending = (tmp, path)
        return path

    def wait_for_async_checkpoints(self) -> None:
        """Block until the write in flight has ended, and promote it."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        pending, self._pending = self._pending, None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        if pending is None:
            return
        tmp, final = pending
        old = final + ".old"
        if os.path.exists(old):
            os.remove(old)
        if os.path.exists(final):
            os.replace(final, old)
        os.replace(tmp, final)
        if os.path.exists(old):
            os.remove(old)
