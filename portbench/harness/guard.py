"""The import guard: nothing the benchmark runs may load JAX or the JAX
package. Names are compared whole by their top-level part (the port's
name begins with the JAX package's)."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "flatquant_tpu"})


def top(name: str) -> str:
    return name.split(".")[0]


def loaded(modules=None) -> list:
    """Forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({top(m) for m in names} & FORBIDDEN)


def imports_of(path: Path) -> set:
    """Top-level names a Python file imports (absolute imports)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {top(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(top(node.module))
    return out
