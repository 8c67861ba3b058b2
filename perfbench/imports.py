"""The check that nothing of JAX or the JAX package ran.

Module names are compared by their top-level part (before the first dot)
as a whole word: ``repro_torch`` is the port and passes, ``repro`` is the
JAX package and does not. `reference_imports` reads the references'
sources, which must import neither the port nor the JAX package.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})
REFERENCE_FORBIDDEN = FORBIDDEN | {"repro_torch"}
REFERENCE_DIR = Path(__file__).with_name("reference")


def forbidden_loaded(modules=None) -> list[str]:
    """Loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in list(names) if m.split(".")[0] in FORBIDDEN)


def source_imports(path: Path) -> set[str]:
    """Top-level names a source file imports."""
    tree = ast.parse(Path(path).read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def reference_imports(directory: Path = REFERENCE_DIR) -> dict[str, list[str]]:
    """Reference file -> the forbidden names it imports (empty when sound)."""
    bad = {}
    for path in sorted(Path(directory).glob("*.py")):
        hit = sorted(source_imports(path) & REFERENCE_FORBIDDEN)
        if hit:
            bad[path.name] = hit
    return bad
