"""The benchmark measures the PyTorch port alone: no module of JAX, Flax,
the JAX package or its TPU benchmark scripts may be loaded.  Names compare
whole, by their top-level part (before the first dot): ``kgc_gcn_torch``
passes where ``kgc_gcn_tpu`` does not."""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "kgc_gcn_tpu", "bench",
                       "chip_smoke"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules: Iterable[str]) -> List[str]:
    """The loaded module names whose top-level name is forbidden."""
    return sorted(m for m in modules if top_level(m) in FORBIDDEN)


def imports_of(path: Path) -> List[str]:
    """Every module a Python file imports by statement, absolute names
    (a relative import is left out: it stays inside the benchmark)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module)
    return out


def forbidden_imports(root: Path) -> List[str]:
    """``file: module`` for each forbidden import under ``root``."""
    return [f"{p}: {m}" for p in sorted(root.rglob("*.py"))
            for m in imports_of(p) if top_level(m) in FORBIDDEN]
