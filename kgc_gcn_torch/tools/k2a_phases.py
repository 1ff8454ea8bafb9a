"""Where K2a's time goes, on the card: variants of a K2 source
(``kgc_gcn_torch/csrc/fused_score_bce.cu`` by default) with its score
product or its softplus terms cut, and clock64 stamps of each block's
thread 0 at the phase boundaries of every tile.

    python -m kgc_gcn_torch.tools.k2a_phases [SOURCE ...]

For each source and each variant (``full``; ``skip_product``: the score
product loop runs no iteration; ``skip_epilogue``: each score plus its bias
is added as it is, with no exp or log1p; ``skip_both``; ``carveout``:
the launcher also asks for the largest shared-memory carveout;
``attr_once``: the launcher raises the kernel's shared-memory limit once
per process, to the most a block may have, not at every call) it prints the
median device ms of 30 calls (CUDA events, a spin kernel ahead of each
call, L2 warm) at the WN18RR and FB15k-237 shapes (B 128, d 200, N 40,943
and 14,541), ``full`` also over 10 calls back to back (the time of
one), and for ``full`` the cycles a tile of each phase, as measured
by block thread 0 (a producer) and thread 256 (an epilogue thread):
  product 0   the score product over the first half of the depth;
  copy 0      the wait for the copy of the second half, the producers'
              barrier, the next tile's first half issued;
  product 1   the product over the second half;
  copy 1      the same for the next tile's first and second halves;
  handover    the wait for the score buffer to be free, the stores, the
              arrival (the end of the producers' tile);
  full wait   the epilogue thread's wait for the scores;
  terms       its reads and the softplus terms of its 32 scores.
The stamps are inserted by matching lines of the source, so a source whose
tile loop or epilogue reads otherwise is refused.  ``full`` is held against
dense_loss_reference.  The variants build with nvcc into build/k2a_phases/
(gitignored).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from kgc_gcn_torch.ops.fused_loss import dense_loss_reference, loss_schedule
from kgc_gcn_torch.tools.k2b_phases import SHAPES, median_ms
from kgc_gcn_torch.utils.cuda_build import CSRC_DIR, NVCC_FLAGS, _nvcc

OUT = Path(__file__).resolve().parents[2] / "build" / "k2a_phases"
VARIANTS = {"full": (), "skip_product": ("SKIP_PRODUCT",),
            "skip_epilogue": ("SKIP_EPILOGUE",),
            "skip_both": ("SKIP_PRODUCT", "SKIP_EPILOGUE"),
            "carveout": ("CARVEOUT",), "attr_once": ("ATTR_ONCE",)}
PHASES = ("product 0", "copy 0", "product 1", "copy 1", "handover",
          "full wait", "terms")


def _stamp(k: int, tid: int = 0) -> str:
    return (f"if (threadIdx.x == {tid}) {{ long long now = clock64(); "
            f"g_stamps[blockIdx.x * 8 + {k}] += now - tprev; tprev = now; }}\n")


def instrument(src: str) -> str:
    """The source with SKIP_PRODUCT / SKIP_EPILOGUE switches and phase
    stamps in K2a's tile loops; raises if a line to match is missing."""
    def rep(old: str, new: str) -> None:
        nonlocal src
        if src.count(old) != 1:
            raise ValueError(f"K2a source: expected one {old!r}")
        src = src.replace(old, new)

    rep("namespace {\n", "__device__ long long g_stamps[8192];\nnamespace {\n")
    rep("for (int kq = 0; kq < kqw; ++kq) {\n    float4 a[",
        "for (int kq = 0; kq < (SKIP_PRODUCT ? 0 : kqw); ++kq) {\n"
        "    float4 a[")
    rep("    for (int u = 0; u < run; ++u) {\n"
        "      const int n0 = (first + u) * kTileN;\n",
        "    for (int u = 0; u < run; ++u) {\n"
        "      long long tprev = clock64();\n"
        "      const int n0 = (first + u) * kTileN;\n")
    rep("        score_product(hs, es, hq, rg, eg, acc);\n",
        "        score_product(hs, es, hq, rg, eg, acc);\n        " + _stamp(0))
    rep("        score_product(hs + hq * kLdH, es + hq * kLdE, kqw - hq, rg, eg, acc);\n",
        "        " + _stamp(1)
        + "        score_product(hs + hq * kLdH, es + hq * kLdE, kqw - hq, rg, eg, acc);\n"
        "        " + _stamp(2))
    rep("                                    d, 4 * hq, kqw - hq);\n"
        "        cp_async_commit();\n",
        "                                    d, 4 * hq, kqw - hq);\n"
        "        cp_async_commit();\n        " + _stamp(3))
    rep("      named_arrive(kBarFull + (u & 1), kLossThreads);\n",
        "      named_arrive(kBarFull + (u & 1), kLossThreads);\n      " + _stamp(4))
    rep("    for (int u = 0; u < run; ++u) {\n"
        "      const int col = (first + u) * kTileN + e;\n",
        "    for (int u = 0; u < run; ++u) {\n"
        "      long long tprev = clock64();\n"
        "      const int col = (first + u) * kTileN + e;\n")
    rep("      named_sync(kBarFull + (u & 1), kLossThreads);\n",
        "      named_sync(kBarFull + (u & 1), kLossThreads);\n      "
        + _stamp(5, 256))
    rep("        sum = add_terms(sum, x[c], wsm + m0 + 16 * c, bj, ok, row_ok[c], base);\n",
        "        sum = add_terms(sum, x[c], wsm + m0 + 16 * c, bj, ok, row_ok[c], base);\n"
        "      " + _stamp(6, 256))
    rep("    e[m] = expf(-fabsf(s[m]));\n",
        "    e[m] = SKIP_EPILOGUE ? s[m] : expf(-fabsf(s[m]));\n")
    rep("  for (int m = 0; m < 16; ++m) e[m] = log1pf(e[m]);\n",
        "  for (int m = 0; m < 16; ++m) e[m] = SKIP_EPILOGUE ? e[m] : log1pf(e[m]);\n")
    rep("  const auto kernel = aligned ? loss_tiles_kernel<true> : loss_tiles_kernel<false>;\n"
        "  cudaError_t err = cudaFuncSetAttribute(\n"
        "      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);\n",
        "  const auto kernel = aligned ? loss_tiles_kernel<true> : loss_tiles_kernel<false>;\n"
        "  if (CARVEOUT) cudaFuncSetAttribute(\n"
        "      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);\n"
        "  static bool attr_done[2] = {};\n"
        "  cudaError_t err = ATTR_ONCE && attr_done[aligned] ? cudaSuccess\n"
        "      : cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
        "                             ATTR_ONCE ? kMaxSmem : smem);\n"
        "  attr_done[aligned] = true;\n")
    return src + '''
extern "C" int kgc_k2a_stamps(void* host, int zero) {
  static long long zeros[8192] = {};
  if (zero) return static_cast<int>(cudaMemcpyToSymbol(g_stamps, zeros, sizeof(zeros)));
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps, sizeof(zeros)));
}
'''


def build(sources: list) -> dict:
    """{(source index, variant): loaded library}, all nvcc runs at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    flags = ("SKIP_PRODUCT", "SKIP_EPILOGUE", "CARVEOUT", "ATTR_ONCE")
    jobs = {}
    for i, source in enumerate(sources):
        cu = OUT / f"src{i}.cu"
        cu.write_text(instrument(Path(source).read_text()))
        for name, on in VARIANTS.items():
            lib = OUT / f"src{i}_{name}.so"
            defs = [f"-D{f}={int(f in on)}" for f in flags]
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
        lib.kgc_fused_bce_loss.argtypes = [vp] * 4 + [f32] + [vp] * 2 + [
            i32] * 7 + [vp]
        lib.kgc_fused_bce_loss.restype = i32
        lib.kgc_k2a_stamps.argtypes = [vp, i32]
        lib.kgc_k2a_stamps.restype = i32
        libs[key] = lib
    return libs


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("k2a_phases: torch sees no CUDA device", file=sys.stderr)
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
        base = 1.0 / n
        sched = loss_schedule(b, n, d, n_sm)
        partials = torch.empty(sched.partials, device="cuda")
        out = torch.empty((), device="cuda")
        want = dense_loss_reference(h, ent, bias, w, base)

        def call(lib):
            code = lib.kgc_fused_bce_loss(
                h.data_ptr(), ent.data_ptr(), bias.data_ptr(), w.data_ptr(),
                base, partials.data_ptr(), out.data_ptr(), b, n, d,
                sched.tiles_per_block, sched.blocks, sched.window,
                sched.n_windows, torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"K2a launch failed: CUDA error {code}")

        print(f"{shape}: B {b}, d {d}, N {n}; {sched}")
        for i, source in enumerate(sources):
            call(libs[(i, "full")])
            torch.cuda.synchronize()
            torch.testing.assert_close(out, want, rtol=1e-5, atol=0.0)
            ms = {name: median_ms(lambda: call(libs[(i, name)]))
                  for name in VARIANTS}
            ms["full, 10 back to back"] = median_ms(
                lambda: [call(libs[(i, "full")]) for _ in range(10)]) / 10
            lib = libs[(i, "full")]
            lib.kgc_k2a_stamps(None, 1)
            call(lib)
            torch.cuda.synchronize()
            stamps = np.zeros(8192, np.int64)
            if lib.kgc_k2a_stamps(stamps.ctypes.data, 0):
                raise RuntimeError("reading the stamps failed")
            tiles = np.array([len(sched.tile_range(x))
                              for x in range(sched.blocks)])
            per_tile = stamps[:8 * sched.blocks].reshape(sched.blocks, 8)[
                :, :len(PHASES)] / tiles[:, None]
            print(f"  {source}\n    ms: " + ", ".join(
                f"{k} {v:.4f}" for k, v in ms.items())
                + "\n    cycles a tile, mean (max) over blocks: " + "; ".join(
                    f"{p} {per_tile[:, j].mean():.0f} ({per_tile[:, j].max():.0f})"
                    for j, p in enumerate(PHASES)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
