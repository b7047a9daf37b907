"""The import check: nothing the benchmark runs may load the JAX package
or JAX, and the reference may load nothing of the program. Module names
are compared by their whole top-level name (the part before the first
dot), so ``neat_tpu_torch`` is not ``neat_tpu``."""

from __future__ import annotations

import ast
import os
import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "neat_tpu")
PROGRAM = "neat_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules: Iterable[str] = None, forbidden=FORBIDDEN) -> List[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names if top_level(m) in forbidden})


def source_imports(path: str) -> List[str]:
    """The top-level names a Python file imports (absolute imports)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [top_level(a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(top_level(node.module))
    return names


def reference_violations(reference_dir: str) -> List[str]:
    """``file: name`` for each import of a reference source that names the
    JAX package, JAX or the program."""
    bad = []
    for fn in sorted(os.listdir(reference_dir)):
        if fn.endswith(".py"):
            for name in source_imports(os.path.join(reference_dir, fn)):
                if name in FORBIDDEN or name == PROGRAM:
                    bad.append(f"{fn}: {name}")
    return bad
