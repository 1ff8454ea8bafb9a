"""Where K2b's time goes, on the card: variants of a K2b source
(``kgc_gcn_torch/csrc/fused_score_bce.cu`` by default) with its product
loops cut, and clock64 stamps of each block's thread 0 at the phase
boundaries of every tile.

    python -m kgc_gcn_torch.tools.k2b_phases [SOURCE ...]

For each source and each variant (``full``; ``skip_p1``, ``skip_p2``,
``skip_p3``: the score, d_ent or d_h product loop runs no iteration;
``skip_all``: none of the three) it prints the median device ms of 30 calls
(CUDA events, a spin kernel ahead of each call, L2 warm) at the WN18RR and
FB15k-237 shapes (B 128, d 200, N 40,943 and 14,541), and for ``full`` the
cycles a tile of each phase, as measured by block thread 0:
  P1      the score product (its own units);
  dl      the dl tile and the barrier after it;
  d_h     d_bias, the d_h product, the barrier and the next tile's copy;
  d_ent   the d_ent product (its own units);
  wait    the wait for the copy and the last barrier.
The stamps are inserted by matching lines of the source, so a source whose
loops or phase comments read otherwise is refused.  ``full`` is held
against dense_grads_reference.  The variants build with nvcc into
build/k2b_phases/ (gitignored).
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from kgc_gcn_torch.ops.fused_loss import dense_grads_reference, grads_schedule
from kgc_gcn_torch.utils.cuda_build import CSRC_DIR, NVCC_FLAGS, _nvcc

OUT = Path(__file__).resolve().parents[2] / "build" / "k2b_phases"
SHAPES = {"wn18rr": (128, 40943, 200), "fb15k237": (128, 14541, 200)}
VARIANTS = {"full": (), "skip_p1": ("SKIP_P1",), "skip_p2": ("SKIP_P2",),
            "skip_p3": ("SKIP_P3",),
            "skip_all": ("SKIP_P1", "SKIP_P2", "SKIP_P3")}
PHASES = ("P1", "dl", "d_h", "d_ent", "wait")


def _stamp(k: int) -> str:
    return ("if (threadIdx.x == 0) { long long now = clock64(); "
            f"g_stamps[blockIdx.x * 8 + {k}] += now - tprev; tprev = now; }}\n")


def instrument(src: str) -> str:
    """The source with SKIP_P1/2/3 switches on its product loops and phase
    stamps in its tile loop; raises if a line to match is missing."""
    def rep(old: str, new: str) -> None:
        nonlocal src
        if src.count(old) != 1:
            raise ValueError(f"K2b source: expected one {old!r}")
        src = src.replace(old, new)

    rep("namespace {\n", "__device__ long long g_stamps[8192];\nnamespace {\n")
    if "kq < kq_end; ++kq) {" in src:    # the score product split by depth
        rep("kq < kq_end; ++kq) {", "kq < (SKIP_P1 ? kq_begin : kq_end); ++kq) {")
    else:
        rep("for (int kq = 0; kq < kqw; ++kq) {\n    float4 a[",
            "for (int kq = 0; kq < (SKIP_P1 ? 0 : kqw); ++kq) {\n"
            "    float4 a[")
    for old, new in (
            ("for (int rq = 0; rq < kChunkRows / 4; ++rq) {",
             "for (int rq = 0; rq < (SKIP_P2 ? 0 : kChunkRows / 4); ++rq) {"),
            ("for (int e = 0; e < kTileN; ++e) {\n      const float4 l",
             "for (int e = 0; e < (SKIP_P3 ? 0 : kTileN); ++e) {\n"
             "      const float4 l"),
            ("    for (int t = t_begin; t < t_end; ++t) {\n",
             "    for (int t = t_begin; t < t_end; ++t) {\n"
             "      long long tprev = clock64();\n"),
            ("      // dl tile, transposed", "      " + _stamp(0)
             + "      // dl tile, transposed"),
            ("      __syncthreads();\n      // d_bias of the tile",
             "      __syncthreads();\n      " + _stamp(1)
             + "      // d_bias of the tile"),
            ("        dent_window<kVec>(", "        " + _stamp(2)
             + "        dent_window<kVec>("),
            ("r0 > 0);\n      }\n      cp_async_wait_all();\n      __syncthreads();"
             "                  // dlT, hs and es are free again\n",
             "r0 > 0);\n        " + _stamp(3) + "      }\n      cp_async_wait_all();\n"
             "      __syncthreads();\n      " + _stamp(4))):
        rep(old, new)
    return src + '''
extern "C" int kgc_k2b_stamps(void* host, int zero) {
  static long long zeros[8192] = {};
  if (zero) return static_cast<int>(cudaMemcpyToSymbol(g_stamps, zeros, sizeof(zeros)));
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps, sizeof(zeros)));
}
'''


def build(sources: list) -> dict:
    """{(source label, variant): loaded library}, all nvcc runs at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, source in enumerate(sources):
        cu = OUT / f"src{i}.cu"
        cu.write_text(instrument(Path(source).read_text()))
        for name, flags in VARIANTS.items():
            lib = OUT / f"src{i}_{name}.so"
            defs = [f"-D{f}=1" for f in flags] + [
                f"-D{f}=0" for f in ("SKIP_P1", "SKIP_P2", "SKIP_P3")
                if f not in flags]
            jobs[(i, name)] = (lib, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, *defs, "-shared", str(cu), "-o",
                 str(lib)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for key, (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(str(path))
        lib.kgc_fused_bce_grads.argtypes = [vp] * 5 + [f32] + [vp] * 4 + [
            i32] * 7 + [vp]
        lib.kgc_fused_bce_grads.restype = i32
        lib.kgc_k2b_stamps.argtypes = [vp, i32]
        lib.kgc_k2b_stamps.restype = i32
        libs[key] = lib
    return libs


def median_ms(fn, n: int = 30) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("k2b_phases: torch sees no CUDA device", file=sys.stderr)
        return 2
    sources = argv or [str(CSRC_DIR / "fused_score_bce.cu")]
    libs = build(sources)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for shape, (b, n, d) in SHAPES.items():
        gen = torch.Generator().manual_seed(0)
        h = torch.relu(torch.randn(b, d, generator=gen)).cuda()
        ent = torch.tanh(torch.randn(n, d, generator=gen)).cuda()
        bias = (torch.randn(n, generator=gen) * 0.1).cuda()
        w = torch.ones(b, device="cuda")
        g = torch.tensor([1.0 / (b * n)], device="cuda")
        base = 1.0 / n
        sched = grads_schedule(b, n, d, n_sm)
        scratch = torch.empty(sched.scratch_floats, device="cuda")
        outs = (torch.empty(b, d, device="cuda"),
                torch.empty(n, d, device="cuda"),
                torch.empty(n, device="cuda"))
        want = dense_grads_reference(g[0], h, ent, bias, w, base)

        def call(lib):
            code = lib.kgc_fused_bce_grads(
                g.data_ptr(), h.data_ptr(), ent.data_ptr(), bias.data_ptr(),
                w.data_ptr(), base, *(o.data_ptr() for o in outs),
                scratch.data_ptr(), b, n, d, sched.tiles_per_block,
                sched.blocks, sched.window, sched.n_windows,
                torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"K2b launch failed: CUDA error {code}")

        print(f"{shape}: B {b}, d {d}, N {n}; {sched}")
        for i, source in enumerate(sources):
            call(libs[(i, "full")])
            torch.cuda.synchronize()
            for got, ref in zip(outs, want):
                torch.testing.assert_close(
                    got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))
            ms = {name: median_ms(lambda: call(libs[(i, name)]))
                  for name in VARIANTS}
            lib = libs[(i, "full")]
            lib.kgc_k2b_stamps(None, 1)
            call(lib)
            torch.cuda.synchronize()
            stamps = np.zeros(8192, np.int64)
            if lib.kgc_k2b_stamps(stamps.ctypes.data, 0):
                raise RuntimeError("reading the stamps failed")
            per_tile = stamps[:8 * sched.blocks].reshape(sched.blocks, 8)[
                :, :len(PHASES)] / sched.tiles_per_block
            print(f"  {source}\n    ms: " + ", ".join(
                f"{k} {v:.4f}" for k, v in ms.items())
                + "\n    cycles a tile, mean (max) over blocks: " + "; ".join(
                    f"{p} {per_tile[:, j].mean():.0f} ({per_tile[:, j].max():.0f})"
                    for j, p in enumerate(PHASES)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
