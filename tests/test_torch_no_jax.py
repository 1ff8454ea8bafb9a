"""The port stands alone: nothing in kgc_gcn_torch/ or chip_smoke.py imports
JAX, jaxlib, kgc_gcn_tpu, orbax or tensorstore (the card has neither), and
importing the port's CLI loads none of them."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "kgc_gcn_tpu", "orbax", "tensorstore")


def _port_files():
    return sorted((ROOT / "kgc_gcn_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, kgc_gcn_torch.cli, kgc_gcn_torch.serve, "
            "kgc_gcn_torch.convert, kgc_gcn_torch.train.loop, "
            "kgc_gcn_torch.train.optim, kgc_gcn_torch.train.checkpoint, "
            "kgc_gcn_torch.ops.fused_loss, kgc_gcn_torch.ops.losses, "
            "kgc_gcn_torch.ops.scatter, kgc_gcn_torch.ops.basis, "
            "kgc_gcn_torch.ops.kernels, kgc_gcn_torch.models.rgcn, "
            "kgc_gcn_torch.train.negative, kgc_gcn_torch.ops.segment_max, "
            "kgc_gcn_torch.ops.sorted_ops, kgc_gcn_torch.models.rgat, "
            "kgc_gcn_torch.ops.elementwise, kgc_gcn_torch.ops.fused_compose, "
            "kgc_gcn_torch.parallel.entity_sharding, "
            "kgc_gcn_torch.parallel.boundary, "
            "kgc_gcn_torch.train.orbax_layout\n"
            "bad = sorted(m for m in sys.modules "
            f"if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(ROOT), timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
