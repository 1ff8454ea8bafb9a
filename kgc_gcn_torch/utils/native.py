"""ctypes bridge to the host data engine ``native/graphcore.cpp`` (the port's
copy of what it needs from ``kgc_gcn_tpu/utils/native.py``).

The library is compiled with ``g++`` from the source in the checkout, at
first use, into ``build/kgc_gcn_torch/libgraphcore-<key>.so``, where the key
hashes the source, the compiler flags and the host's platform: a changed
source builds a new file, and a file is never rebuilt in place.  Each
builder writes a temporary file of its own and ``os.replace``s it into
place, so concurrent builders (test workers, ranks, threads) never load half
a file.  ``native/libgraphcore.so`` belongs to the JAX package's wrapper and
is never touched here.

Unlike the JAX wrapper, a failed build raises with the compiler's output: the
numpy engines run only where a caller asks for them (``use_native=False``).

Entry points (each the numpy engine's exact twin, field for field):

  * ``load_corpus_native``: the three TSV triple files -> vocabularies in
    first-seen, lowercased order and (n, 3) id triples per split;
  * ``build_half_native``: one CSR half's stable dst-sort permutation, row
    pointers and reference degree norm (the C++ ``1/sqrt`` may differ from
    numpy's ``deg**-0.5`` in the last bit, so ``data/graph.py`` takes the
    norm from numpy in both engines);
  * ``group_sr2o_native`` / ``group_sr2o_splits_native``: the sr2o label
    grouping (first-seen keys, first-seen-deduped values, offsets), all
    splits and the train-only snapshot in one hash pass;
  * ``locality_order_native``: the label-propagation community order of
    ``--partition locality``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from kgc_gcn_torch.utils.cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "graphcore.cpp"
# portable code: the build directory may travel to another host
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LIB = None
_LOCK = threading.Lock()


def library_path() -> Path:
    """Where the library of the current source, flags and host platform is
    built (a build directory copied to another host builds anew)."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        CXX_FLAGS + [platform.platform()]).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libgraphcore-{key}.so"


def build() -> Path:
    """Compile the library unless this source's build exists; returns its
    path.  Raises with the compiler's output when ``g++`` fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a name of this builder's own (process and thread)
    tmp = path.with_name(
        f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        out = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the host data engine "
                           "(native/graphcore.cpp) is built with g++") from e
    if out.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{out.stderr}")
    os.replace(tmp, path)   # atomic: a concurrent loader sees all or nothing
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    sigs = {
        "gc_load_corpus": ([ctypes.c_char_p] * 3, vp),
        "gc_error": ([vp], ctypes.c_char_p),
        "gc_num_triples": ([vp, i32], i64),
        "gc_copy_triples": ([vp, i32, i32p], None),
        "gc_vocab_bytes": ([vp, i32], i64),
        "gc_copy_vocab": ([vp, i32, ctypes.c_char_p], None),
        "gc_free": ([vp], None),
        "gc_build_half": ([i32p, i32p, i64, i32, i32p, i32p, f32p], None),
        "gc_group_sr2o": ([i64p, i64, i32], vp),
        "gc_group_sr2o_splits": ([i64p, i64, i64, i32], vp),
        "gc_group2_get": ([vp, i32], vp),
        "gc_group2_free": ([vp], None),
        "gc_group_n": ([vp], i64),
        "gc_group_nvals": ([vp], i64),
        "gc_group_copy": ([vp, i64p, i32p, i64p], None),
        "gc_group_free": ([vp], None),
        "gc_locality_order": ([i32p, i32p, i64, i32, i32p], None),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def get_lib() -> ctypes.CDLL:
    """The library, built on first use and loaded once per process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(build())))
        return _LIB


def load_corpus_native(train_path: str, valid_path: str, test_path: str
                       ) -> Tuple[Dict[str, int], Dict[str, int],
                                  Dict[str, np.ndarray]]:
    """(entity2id, forward relation2id, {split: (n, 3) int64 triples}).
    A malformed line raises ``ValueError`` with the file and line."""
    lib = get_lib()
    h = lib.gc_load_corpus(train_path.encode(), valid_path.encode(),
                           test_path.encode())
    try:
        err = lib.gc_error(h)
        if err:
            raise ValueError(err.decode())
        triples = {}
        for i, split in enumerate(("train", "valid", "test")):
            out = np.empty((lib.gc_num_triples(h, i), 3), np.int32)
            if len(out):
                lib.gc_copy_triples(h, i, out.reshape(-1))
            triples[split] = out.astype(np.int64)
        vocabs = []
        for which in (0, 1):
            buf = ctypes.create_string_buffer(
                int(lib.gc_vocab_bytes(h, which)))
            lib.gc_copy_vocab(h, which, buf)
            names = buf.value.decode().split("\n")[:-1]
            vocabs.append({name: i for i, name in enumerate(names)})
        return vocabs[0], vocabs[1], triples
    finally:
        lib.gc_free(h)


def _edges(src: np.ndarray, dst: np.ndarray, n_ent: int):
    """The edge list as contiguous int32 arrays, checked: the C++ side
    indexes its arrays by these ids unchecked."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"src {src.shape} and dst {dst.shape} must be one "
                         "(E,) shape")
    if len(src) and (min(src.min(), dst.min()) < 0
                     or max(src.max(), dst.max()) >= n_ent):
        raise ValueError(f"edge ids must lie in [0, {n_ent})")
    return src, dst


def build_half_native(src: np.ndarray, dst: np.ndarray, n_ent: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(stable dst-sort permutation, CSR pointers, reference norm in the
    unsorted edge order) of one half."""
    src, dst = _edges(src, dst, n_ent)
    e = len(src)
    perm = np.empty(e, np.int32)
    indptr = np.empty(n_ent + 1, np.int32)
    norm = np.empty(e, np.float32)
    get_lib().gc_build_half(src, dst, e, n_ent, perm, indptr, norm)
    return perm, indptr, norm


def locality_order_native(src: np.ndarray, dst: np.ndarray,
                          n_ent: int) -> np.ndarray:
    """(n_ent,) int32 label-propagation order of the undirected edge list:
    ``order[k]`` is the old id of new id ``k``."""
    src, dst = _edges(src, dst, n_ent)
    order = np.empty(n_ent, np.int32)
    get_lib().gc_locality_order(src, dst, len(src), n_ent, order)
    return order


def _copy_group(lib, h) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    keys = np.empty(int(lib.gc_group_n(h)), np.int64)
    values = np.empty(int(lib.gc_group_nvals(h)), np.int32)
    offsets = np.empty(len(keys) + 1, np.int64)
    lib.gc_group_copy(h, keys, values, offsets)
    return keys, values, offsets


def group_sr2o_native(triples: np.ndarray, num_relation: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The sr2o grouping of (n, 3) int64 id triples: (first-seen keys
    ``s*2R + r`` (G,) int64, grouped first-seen-deduped values (V,) int32,
    offsets (G+1,) int64)."""
    lib = get_lib()
    tri = np.ascontiguousarray(triples, np.int64)
    h = lib.gc_group_sr2o(tri.reshape(-1), len(tri), num_relation)
    try:
        return _copy_group(lib, h)
    finally:
        lib.gc_group_free(h)


def group_sr2o_splits_native(triples: np.ndarray, n_train: int,
                             num_relation: int) -> Tuple[Tuple, Tuple]:
    """Both groupings of one pass: (as of the first ``n_train`` triples,
    the train-only snapshot of reference data_loader.py:88-90; over all
    triples), each ``(keys, values, offsets)``."""
    lib = get_lib()
    tri = np.ascontiguousarray(triples, np.int64)
    h = lib.gc_group_sr2o_splits(tri.reshape(-1), len(tri), n_train,
                                 num_relation)
    try:
        return (_copy_group(lib, lib.gc_group2_get(h, 0)),
                _copy_group(lib, lib.gc_group2_get(h, 1)))
    finally:
        lib.gc_group2_free(h)
