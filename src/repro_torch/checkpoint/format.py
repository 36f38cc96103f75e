"""CMI manifest format: chunk tables, sharding records, structure skeletons.

The manifest is plain JSON so that it is inspectable with standard tools and
robust across Python/framework versions (no pickling of live objects — the paper's
"restart script" analogue is deterministic reconstruction from config, so the
manifest only needs dtypes/shapes/slices, not code).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

FORMAT_NAME = "navp-cmi"
# Version history:
#   1 — implicit (manifests without a "version" field): single data-0.bin
#   2 — explicit version field, same single-file layout
#   3 — multi-file striped layout (data-0.bin … data-{W-1}.bin) + "data_files"
#   4 — content-addressed layout: the CMI dir holds only the manifest; every
#       chunk is a digest reference into the store-level object tree
#       (ref="objects/<digest[:2]>", file=<digest>, offset=0) — see
#       repro_torch.checkpoint.cas. "data_files" is empty.
# Readers accept any version <= FORMAT_VERSION; chunk entries name their
# owner + file, so v1/v2 CMIs load through the same path as v3, and v4
# digest references resolve through the same owner/file join.
FORMAT_VERSION = 4


# Manifest dtype names are numpy's names, as the JAX package writes them.
# torch.bfloat16 (and the float8 types) have no numpy dtype here: their
# bytes travel through an unsigned integer view of the same width, under the
# name the JAX package's ml_dtypes gives them.
_TORCH_TO_NAME: dict[torch.dtype, str] = {
    torch.bool: "bool",
    torch.uint8: "uint8",
    torch.int8: "int8",
    torch.int16: "int16",
    torch.int32: "int32",
    torch.int64: "int64",
    torch.float16: "float16",
    torch.bfloat16: "bfloat16",
    torch.float32: "float32",
    torch.float64: "float64",
    torch.complex64: "complex64",
    torch.complex128: "complex128",
}
for _name in ("uint16", "uint32", "uint64"):
    if hasattr(torch, _name):
        _TORCH_TO_NAME[getattr(torch, _name)] = _name
for _attr, _name in (("float8_e4m3fn", "float8_e4m3fn"), ("float8_e5m2", "float8_e5m2")):
    if hasattr(torch, _attr):
        _TORCH_TO_NAME[getattr(torch, _attr)] = _name
_NAME_TO_TORCH = {v: k for k, v in _TORCH_TO_NAME.items()}

# names numpy cannot hold -> (itemsize, unsigned storage dtype of that width)
_VIEW_ONLY = {
    "bfloat16": np.dtype(np.uint16),
    "float8_e4m3fn": np.dtype(np.uint8),
    "float8_e5m2": np.dtype(np.uint8),
}


def dtype_to_str(dt: Any) -> str:
    """Manifest name of a torch or numpy dtype."""
    if isinstance(dt, torch.dtype):
        try:
            return _TORCH_TO_NAME[dt]
        except KeyError:
            raise TypeError(f"dtype {dt} has no CMI manifest name") from None
    return np.dtype(dt).name


def storage_dtype(name: str) -> np.dtype:
    """The numpy dtype whose bytes hold an array of manifest dtype ``name``."""
    return _VIEW_ONLY.get(name) or np.dtype(name)


def dtype_itemsize(name: str) -> int:
    return storage_dtype(name).itemsize


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _NAME_TO_TORCH[name]
    except KeyError:
        raise TypeError(f"manifest dtype {name!r} has no torch dtype") from None


# ---------------------------------------------------------------------------
# chunk / array entries
# ---------------------------------------------------------------------------


@dataclass
class ChunkEntry:
    """One contiguous serialized block covering ``slice`` of the full array.

    ``ref`` is ``None`` for chunks in this CMI's own data file, or the name of
    an ancestor CMI directory (sibling in the same store) for delta chunks
    that were *not* rewritten because their content hash matched the parent.
    v4 chunks set ``ref="objects/<digest[:2]>"`` and ``file=<digest>`` — a
    digest reference into the store's content-addressed object tree, resolved
    by the same ``<store_root>/<ref>/<file>`` join as delta references.
    """

    slice: list[list[int]]  # [[start, stop], ...] per dim, full-array coords
    file: str  # data file name within the owning CMI dir
    offset: int
    nbytes: int
    crc32: int
    hash: str  # blake2b-128 of raw bytes (delta compare key)
    ref: str | None = None  # owning CMI dir name if not self

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        if d["ref"] is None:
            del d["ref"]
        return d

    @staticmethod
    def from_json(d: dict) -> "ChunkEntry":
        return ChunkEntry(
            slice=[list(map(int, s)) for s in d["slice"]],
            file=d["file"],
            offset=int(d["offset"]),
            nbytes=int(d["nbytes"]),
            crc32=int(d["crc32"]),
            hash=d["hash"],
            ref=d.get("ref"),
        )


@dataclass
class ShardingRecord:
    """Serialized NamedSharding: enough to rebuild or *re-map* on a new mesh."""

    mesh_shape: list[int]
    mesh_axes: list[str]
    pspec: list[Any]  # PartitionSpec entries: str | list[str] | None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict | None) -> "ShardingRecord | None":
        if d is None:
            return None
        return ShardingRecord(
            mesh_shape=list(d["mesh_shape"]),
            mesh_axes=list(d["mesh_axes"]),
            pspec=list(d["pspec"]),
        )


@dataclass
class ArrayEntry:
    shape: list[int]
    dtype: str
    chunks: list[ChunkEntry]
    sharding: ShardingRecord | None = None

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * dtype_itemsize(self.dtype)

    def to_json(self) -> dict:
        return {
            "shape": self.shape,
            "dtype": self.dtype,
            "chunks": [c.to_json() for c in self.chunks],
            "sharding": self.sharding.to_json() if self.sharding else None,
        }

    @staticmethod
    def from_json(d: dict) -> "ArrayEntry":
        return ArrayEntry(
            shape=list(map(int, d["shape"])),
            dtype=d["dtype"],
            chunks=[ChunkEntry.from_json(c) for c in d["chunks"]],
            sharding=ShardingRecord.from_json(d.get("sharding")),
        )


@dataclass
class Manifest:
    """Everything needed to restore a CMI — arrays, scalars, and structure."""

    step: int
    meta: dict[str, Any]
    structure: Any  # JSON skeleton; array leaves are {"$array": path}
    arrays: dict[str, ArrayEntry]
    parent: str | None = None  # delta parent CMI name (for GC refcounting)
    format: str = FORMAT_NAME
    version: int = FORMAT_VERSION
    # Striped data files this CMI owns (["data-0.bin", ...]). Informational —
    # chunk entries name their file — but lets tooling/GC enumerate shard
    # files without scanning the chunk table. Empty for v1/v2 manifests.
    data_files: list[str] = field(default_factory=list)
    extra: dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> dict:
        out = {
            "format": self.format,
            "version": self.version,
            "step": self.step,
            "meta": self.meta,
            "parent": self.parent,
            "structure": self.structure,
            "arrays": {k: v.to_json() for k, v in self.arrays.items()},
            "extra": self.extra,
        }
        if self.data_files:
            out["data_files"] = self.data_files
        return out

    @staticmethod
    def from_json(d: dict) -> "Manifest":
        if d.get("format") != FORMAT_NAME:
            raise ValueError(f"not a {FORMAT_NAME} manifest: {d.get('format')!r}")
        version = int(d.get("version", 1))
        if version > FORMAT_VERSION:
            raise ValueError(
                f"manifest version {version} is newer than supported "
                f"({FORMAT_VERSION}); upgrade the reader"
            )
        return Manifest(
            step=int(d["step"]),
            meta=d.get("meta", {}),
            structure=d["structure"],
            arrays={k: ArrayEntry.from_json(v) for k, v in d["arrays"].items()},
            parent=d.get("parent"),
            version=version,
            data_files=list(d.get("data_files", [])),
            extra=d.get("extra", {}),
        )

    def dumps(self) -> str:
        return json.dumps(self.to_json(), sort_keys=True)

    @staticmethod
    def loads(s: str) -> "Manifest":
        return Manifest.from_json(json.loads(s))


# ---------------------------------------------------------------------------
# structure skeleton: pytree <-> JSON (arrays referenced by path)
# ---------------------------------------------------------------------------
# Supported containers: dict (str keys), list, tuple. Leaves: arrays (handled
# by caller via the `paths` set), python scalars (int/float/bool/str/None).
# This deliberately excludes arbitrary objects — a CMI must be loadable by a
# *fresh* process with no access to the original class definitions.


def encode_structure(tree: Any, array_paths: set[str], prefix: str = "") -> Any:
    def rec(node: Any, path: str) -> Any:
        if isinstance(node, dict):
            for k in node:
                if not isinstance(k, str):
                    raise TypeError(f"dict keys must be str, got {k!r} at {path!r}")
            return {
                "$kind": "dict",
                "items": {
                    k: rec(v, f"{path}/{k}" if path else k) for k, v in node.items()
                },
            }
        if isinstance(node, tuple):
            return {
                "$kind": "tuple",
                "items": [rec(v, f"{path}/{i}" if path else str(i)) for i, v in enumerate(node)],
            }
        if isinstance(node, list):
            return {
                "$kind": "list",
                "items": [rec(v, f"{path}/{i}" if path else str(i)) for i, v in enumerate(node)],
            }
        key = path or "."  # root-leaf convention matches flatten_with_paths
        if key in array_paths:
            return {"$array": key}
        if node is None or isinstance(node, (bool, int, float, str)):
            return {"$scalar": node}
        if isinstance(node, (np.integer,)):
            return {"$scalar": int(node)}
        if isinstance(node, (np.floating,)):
            return {"$scalar": float(node)}
        raise TypeError(
            f"unsupported leaf type {type(node).__name__} at {path!r}; CMIs hold "
            "only arrays, scalars, and dict/list/tuple containers"
        )

    return rec(tree, prefix)


def decode_structure(skel: Any, arrays: dict[str, Any]) -> Any:
    def rec(node: Any) -> Any:
        if not isinstance(node, dict):
            raise ValueError(f"malformed skeleton node: {node!r}")
        if "$array" in node:
            return arrays[node["$array"]]
        if "$scalar" in node:
            return node["$scalar"]
        kind = node.get("$kind")
        if kind == "dict":
            return {k: rec(v) for k, v in node["items"].items()}
        if kind == "tuple":
            return tuple(rec(v) for v in node["items"])
        if kind == "list":
            return [rec(v) for v in node["items"]]
        raise ValueError(f"malformed skeleton node: {node!r}")

    return rec(skel)


# ---------------------------------------------------------------------------
# tensor <-> storage bytes
# ---------------------------------------------------------------------------


def tensor_to_storage(t: torch.Tensor) -> np.ndarray:
    """Host numpy array (storage dtype) holding the bytes of ``t``.

    Copies a CUDA tensor to the host; a contiguous CPU tensor is viewed
    without a copy. bfloat16 and float8 go through an integer view of the
    same width, so the bytes are exactly the tensor's.
    """
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.contiguous()
    name = dtype_to_str(t.dtype)
    if name in _VIEW_ONLY:
        view = torch.int16 if t.element_size() == 2 else torch.uint8
        return t.view(view).numpy().view(_VIEW_ONLY[name])
    return t.numpy()


def storage_to_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    """CPU tensor of manifest dtype ``name`` over the storage array ``arr``."""
    if name in _VIEW_ONLY:
        if arr.dtype.itemsize == 2:
            return torch.from_numpy(arr.view(np.int16)).view(torch_dtype(name))
        return torch.from_numpy(arr.view(np.uint8)).view(torch_dtype(name))
    return torch.from_numpy(arr)
