"""What a run may not load: the JAX package or JAX itself.

Module names are compared by their top-level name (the part before the
first dot) as a whole word, so ``repro_torch`` (the program) passes and
``repro`` (the JAX package) does not. The plain reference imports nothing
of the program either: neither its source nor its namespace may name
``repro_torch``, ``repro``, ``jax``, ``jaxlib`` or ``flax``.
"""

from __future__ import annotations

import ast
import sys
import types
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
NOT_IN_REFERENCE = FORBIDDEN | {"repro_torch"}


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if top(m) in FORBIDDEN)


def reference_imports(module: types.ModuleType) -> list[str]:
    """What the reference module imports or holds of the forbidden
    packages: every import in its source, and every module in its
    namespace (or the module of any function or class there)."""
    found = set()
    tree = ast.parse(Path(module.__file__).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            found.add(node.module)
    for value in vars(module).values():
        if isinstance(value, types.ModuleType):
            found.add(value.__name__)
        elif getattr(value, "__module__", None):
            found.add(value.__module__)
    return sorted(n for n in found if top(n) in NOT_IN_REFERENCE)
