"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``kgc_gcn_torch/csrc/*.cu`` file has a plain ``extern "C"`` interface.
Each source compiles to its own object, all ``nvcc`` processes at once, and
the objects link into ``build/kgc_gcn_torch/libkgc_kernels.so`` at the root
of the checkout.  The library is rebuilt when a source is newer than it, and
loaded once per process.  Nothing here runs at import time: the CPU tests
import every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kgc_gcn_torch"
LIB_NAME = "libkgc_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an up-to-date build was reused
    build_log: str         # nvcc / ptxas -v output of the build ("" if reused)
    segment_sum_chunk: int   # K1's edges per chunk: its carry has ceil(E/C) rows


_LOADED: Optional[KernelLibrary] = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH, /usr/local/cuda/bin): the port's CUDA "
            "kernels are built on the machine with the card")
    return nvcc


def build(force: bool = False):
    """Compile and link the kernels; returns (library path, seconds, log)."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    lib_path = BUILD_DIR / LIB_NAME
    newest = max(p.stat().st_mtime for p in CSRC_DIR.iterdir())
    if (not force and lib_path.exists()
            and lib_path.stat().st_mtime >= newest):
        return lib_path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = str(os.getpid())   # concurrent builders never share a file
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [(src.name, log) for src, proc, log
                  in zip(sources, procs, logs) if proc.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {name}\n{log}" for name, log in failed))
        tmp = BUILD_DIR / f"{LIB_NAME}.{tag}.tmp"
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib_path)   # atomic: a concurrent loader never sees half a file
    return lib_path, time.perf_counter() - t0, "".join(logs) + link.stdout


def load_kernels(force_build: bool = False) -> KernelLibrary:
    """The kernel library, built on first use and loaded once per process.

    ``force_build`` recompiles even an up-to-date build; it must come before
    the first load in the process, since a loaded library cannot be replaced.
    """
    global _LOADED
    if _LOADED is not None:
        if force_build:
            raise RuntimeError("the kernel library is already loaded")
        return _LOADED
    path, seconds, log = build(force_build)
    lib = ctypes.CDLL(str(path))
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kgc_segment_sum_chunk.argtypes = []
    lib.kgc_segment_sum_chunk.restype = i32
    lib.kgc_segment_sum.argtypes = [vp, i32, vp, vp, vp, vp, i32, i32, i32,
                                    vp]
    lib.kgc_segment_sum.restype = i32
    lib.kgc_segment_max.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32,
                                    vp]
    lib.kgc_segment_max.restype = i32
    lib.kgc_fused_bce_loss_smem.argtypes = [i32]
    lib.kgc_fused_bce_loss_smem.restype = i32
    lib.kgc_fused_bce_loss_partials.argtypes = [i32, i32, i32]
    lib.kgc_fused_bce_loss_partials.restype = i32
    lib.kgc_fused_bce_loss.argtypes = [vp, vp, vp, vp, f32, vp, vp, i32, i32,
                                       i32, i32, i32, i32, i32, vp]
    lib.kgc_fused_bce_loss.restype = i32
    lib.kgc_fused_bce_grads_smem.argtypes = [i32]
    lib.kgc_fused_bce_grads_smem.restype = i32
    lib.kgc_fused_bce_grads.argtypes = [vp, vp, vp, vp, vp, f32, vp, vp, vp,
                                        vp, i32, i32, i32, i32, i32, i32, i32,
                                        vp]
    lib.kgc_fused_bce_grads.restype = i32
    lib.kgc_basis_sum.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                  i32, i32, vp]
    lib.kgc_basis_sum.restype = i32
    lib.kgc_basis_bwd.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                  i32, vp]
    lib.kgc_basis_bwd.restype = i32
    lib.kgc_fused_compose.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                      i32, i32, i32, i32, i32, i32, vp]
    lib.kgc_fused_compose.restype = i32
    i64 = ctypes.c_int64
    lib.kgc_compose_msg.argtypes = [vp, vp, vp, vp, i32, i64, vp]
    lib.kgc_compose_msg.restype = i32
    lib.kgc_bwd_products.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32, i64, vp]
    lib.kgc_bwd_products.restype = i32
    lib.kgc_cuda_error_string.argtypes = [i32]
    lib.kgc_cuda_error_string.restype = ctypes.c_char_p
    _LOADED = KernelLibrary(lib, path, seconds, log,
                            lib.kgc_segment_sum_chunk())
    return _LOADED


def check_launch(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.kgc_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")
