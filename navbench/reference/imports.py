"""What the reference imports, read from its own sources.

`imported()` lists the names of the modules that each file of this folder
and its subfolders imports; `forbidden()` those that the reference may not
import: the program (the PyTorch package), JAX and the JAX package, and
any part of the benchmark outside the reference. Names are compared whole,
up to the first dot: the program's name begins with the JAX package's.
"""

from __future__ import annotations

import ast
import os

FORBIDDEN = ("jax", "jaxlib", "flax", "mesh_navigation_tpu", "mesh_navigation_torch")
HERE = os.path.dirname(os.path.abspath(__file__))
OWN = "navbench.reference"   # the reference's own modules, imported by name


def imported(folder: str = HERE) -> dict[str, set]:
    """{file path under `folder`: names of the modules it imports} for each
    .py file (relative imports, the folder's own modules, are left out)."""
    out = {}
    for base, dirs, files in os.walk(folder):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for name in sorted(f for f in files if f.endswith(".py")):
            path = os.path.join(base, name)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            mods = set()
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods.update(a.name for a in node.names)
                elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                    mods.add(node.module)
            out[os.path.relpath(path, folder)] = mods
    return out


def _bad(module: str) -> bool:
    top = module.split(".")[0]
    if top == OWN.split(".")[0]:
        return module != OWN and not module.startswith(OWN + ".")
    return top in FORBIDDEN


def forbidden(folder: str = HERE) -> list[str]:
    """["file: module", ...] for each forbidden import; empty when clean."""
    return [f"{f}: {m}" for f, mods in imported(folder).items()
            for m in sorted(mods) if _bad(m)]


def check() -> None:
    bad = forbidden()
    if bad:
        raise ImportError(f"the reference imports what it may not: {bad}")
