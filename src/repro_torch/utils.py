"""Shared small utilities: tree path flattening, devices, sizes, hashing.

The path strings and the leaf order of :func:`flatten_with_paths` are
byte-identical to the JAX package's (``repro/utils.py``), because manifests
key arrays by these strings and the delta bitmaps follow this order:

* dict keys are sorted (``OrderedDict`` keeps insertion order);
* list and tuple items are keyed by index, namedtuple items by field name;
* ``None`` is an empty subtree, not a leaf;
* a tree that is a single leaf has the path ``"."``.
"""

from __future__ import annotations

import collections
import hashlib
import logging
import math
import os
import time
import zlib
from typing import Any, Iterable

import numpy as np
import torch

logger = logging.getLogger("repro_torch")
if not logger.handlers:  # configure once; launchers may reconfigure
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("REPRO_LOGLEVEL", "INFO"))


# ---------------------------------------------------------------------------
# devices: entry points run on the card unless the caller asks for the CPU
# ---------------------------------------------------------------------------


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    Asking for CUDA where there is none raises: nothing falls back to the
    CPU behind the caller's back.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run on the host"
        )
    return dev


_cpu_math_warm = False


def warm_cpu_math(x: torch.Tensor) -> None:
    """Make this process's first call into PyTorch's CPU vector math (sin,
    cos, ...) on a throwaway tensor, before one on ``x``. A process's first
    such call can return other bits in whole 2048-element chunks when
    several processes start at once (a first-use race in the library; every
    later call agrees), and the stages that use these functions are held
    bitwise across processes. A no-op off the CPU and after the first call."""
    global _cpu_math_warm
    if x.device.type == "cpu" and not _cpu_math_warm:
        torch.sin(torch.zeros(1 << 15, dtype=torch.float64))
        _cpu_math_warm = True


# ---------------------------------------------------------------------------
# tree <-> flat dict keyed by "/"-joined path strings
# ---------------------------------------------------------------------------


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node: Any) -> list[tuple[str, Any]] | None:
    """``[(key, child)]`` for a container, ``None`` for a leaf."""
    if isinstance(node, collections.OrderedDict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


class TreeDef:
    """The structure of a flattened tree; :meth:`unflatten` rebuilds it."""

    def __init__(self, tree: Any, is_leaf=None):
        self._tree = tree
        self._is_leaf = is_leaf
        self.paths: list[str] = []

    @property
    def num_leaves(self) -> int:
        return len(self.paths)

    def unflatten(self, flat: dict[str, Any]) -> Any:
        return _unflatten(self._tree, "", flat, self._is_leaf)


# The walks are module-level functions, not closures that call themselves: a
# self-referencing closure is a reference cycle, and it would keep the
# leaves it holds (a train state's tensors on the card) alive until the
# garbage collector runs.


def _unflatten(node: Any, path: str, flat: dict[str, Any], is_leaf=None) -> Any:
    leaf = is_leaf is not None and is_leaf(node)
    if node is None and not leaf:
        return None
    kids = None if leaf else _children(node)
    if kids is None:
        key = path or "."
        if key not in flat:
            raise KeyError(f"missing leaf {key!r} during unflatten")
        return flat[key]
    built = {k: _unflatten(v, f"{path}/{k}" if path else k, flat, is_leaf) for k, v in kids}
    if isinstance(node, dict):
        return type(node)((k, built[str(k)]) for k in node)
    if _is_namedtuple(node):
        return type(node)(*(built[f] for f in node._fields))
    items = [built[str(i)] for i in range(len(node))]
    return tuple(items) if isinstance(node, tuple) else items


def _flatten_into(node: Any, path: str, flat: dict[str, Any], paths: list[str],
                  is_leaf=None) -> None:
    leaf = is_leaf is not None and is_leaf(node)
    if node is None and not leaf:
        return
    kids = None if leaf else _children(node)
    if kids is None:
        key = path or "."
        if key in flat:
            raise ValueError(f"duplicate flattened key {key!r}")
        flat[key] = node
        paths.append(key)
        return
    for k, v in kids:
        _flatten_into(v, f"{path}/{k}" if path else k, flat, paths, is_leaf)


def flatten_with_paths(tree: Any, is_leaf=None) -> tuple[dict[str, Any], TreeDef]:
    """Flatten ``tree`` to ``{path: leaf}`` plus the treedef for unflattening.
    ``is_leaf(node)`` true stops the walk at ``node`` (``None`` included),
    as ``jax.tree_util``'s ``is_leaf`` does."""
    treedef = TreeDef(tree, is_leaf)
    flat: dict[str, Any] = {}
    _flatten_into(tree, "", flat, treedef.paths, is_leaf)
    return flat, treedef


def unflatten_from_paths(treedef: TreeDef, flat: dict[str, Any]) -> Any:
    """Inverse of :func:`flatten_with_paths`: every leaf path of ``treedef``
    must be in ``flat``."""
    return treedef.unflatten(flat)


def tree_map(fn, tree: Any) -> Any:
    """Apply ``fn`` to every leaf, keeping the structure."""
    flat, treedef = flatten_with_paths(tree)
    return treedef.unflatten({k: fn(v) for k, v in flat.items()})


# ---------------------------------------------------------------------------
# numpy <-> tensor (the shared on-disk format is how state crosses packages)
# ---------------------------------------------------------------------------


def numpy_to_tensor(x: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """A tensor on ``device`` with the same dtype and bytes as ``x``.

    A ``bfloat16`` array (the JAX package's, from ml_dtypes) crosses through
    an int16 view, since numpy has no bfloat16 of its own.
    """
    x = np.ascontiguousarray(x).reshape(x.shape)
    if x.dtype.name == "bfloat16":
        t = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x)
    return t.to(device)


def from_numpy_tree(tree: Any, device: torch.device | str) -> Any:
    """Every numpy array leaf of ``tree`` as a tensor on ``device``."""
    return tree_map(
        lambda v: numpy_to_tensor(v, device) if isinstance(v, np.ndarray) else v, tree
    )


# ---------------------------------------------------------------------------
# sizes / formatting
# ---------------------------------------------------------------------------


def nbytes_of(x: Any) -> int:
    """Bytes of a tensor, an array or a TensorSpec (anything with a shape
    and a dtype); 0 for anything else."""
    if not hasattr(x, "shape"):
        return 0
    dt = x.dtype
    size = dt.itemsize if isinstance(dt, torch.dtype) else np.dtype(dt).itemsize
    return math.prod(x.shape) * size


def tree_nbytes(tree: Any) -> int:
    return sum(nbytes_of(leaf) for leaf in flatten_with_paths(tree)[0].values())


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}TiB"


def prod(xs: Iterable[int]) -> int:
    return math.prod(xs)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


# ---------------------------------------------------------------------------
# hashing (content ids for delta checkpoints)
# ---------------------------------------------------------------------------


def content_hash(buf: bytes | memoryview) -> str:
    return hashlib.blake2b(buf, digest_size=16).hexdigest()


def crc32_of(buf: bytes | memoryview) -> int:
    return zlib.crc32(buf) & 0xFFFFFFFF


class StepTimer:
    """Wall-clock timer with named laps."""

    def __init__(self) -> None:
        self.t0 = time.perf_counter()
        self.laps: list[tuple[str, float]] = []

    def lap(self, name: str) -> float:
        t = time.perf_counter()
        dt = t - self.t0
        self.laps.append((name, dt))
        self.t0 = t
        return dt
