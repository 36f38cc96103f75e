"""Logical-axis sharding rules (MaxText-style) with divisibility fallback.

Port of the JAX package's ``repro/distributed/sharding.py``: the rule
tables and ``spec_for`` are copied, so a tensor gets the same
PartitionSpec in both packages. Every parameter/cache dimension carries a
*logical* name (``Model.param_axes``); a rule table maps each name to an
ordered list of mesh-axis candidates. ``spec_for`` walks a tensor's dims
greedily: the first candidate whose mesh axes are (a) present in the mesh,
(b) not already consumed by an earlier dim of the same tensor, and (c)
divide the dim size, wins; otherwise the dim is replicated.

A spec becomes DTensor placements by :func:`placements_for`: ``Shard(d)``
on every mesh dim that an entry of tensor dim ``d`` names, ``Replicate()``
elsewhere. DTensor nests the shards of one tensor dim in mesh-dim order,
so the device at mesh coordinate ``c`` holds block ``c[a1] * size(a2) +
c[a2]`` of an entry ``(a1, a2)`` — the row-major order of JAX's
``P((a1, a2))`` — when ``a1`` comes before ``a2`` in the mesh. An entry
in the other order has no such placement and raises (the rules make only
``("pod", "data")`` and ``("data", "model")``, which are in mesh order).

``spec_for`` is duck-typed over a mesh's axis sizes: a ``DeviceMesh``, or
an :class:`AbstractMesh` that needs no process group (the rule tests).

Rule sets:
  DEFAULT_RULES — parameters + activations (Megatron-style TP on `model`,
                  experts across the full mesh, batch across pod×data).
  OPT_RULES     — optimizer moments/master: same, plus `embed` → data
                  (ZeRO-style: the dim that is replicated for params is
                  sharded for optimizer state).
  CACHE_RULES   — decode caches: batch → pod×data, seq → model
                  (flash-decoding-style sequence-sharded KV).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import torch

from repro_torch.checkpoint.format import ShardingRecord
from repro_torch.utils import flatten_with_paths, unflatten_from_paths

Rules = Mapping[str, Sequence[tuple[str, ...]]]

DEFAULT_RULES: dict[str, list[tuple[str, ...]]] = {
    "vocab": [("model",)],
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "mlp": [("model",)],
    "moe_mlp": [],
    "experts": [("data", "model"), ("model",)],
    "embed": [],
    "head_dim": [],
    "q_lora": [],
    "layers": [],
    "batch": [("pod", "data"), ("data",)],
    "seq": [],
}

OPT_RULES: dict[str, list[tuple[str, ...]]] = {
    **DEFAULT_RULES,
    "embed": [("data",)],  # ZeRO: shard what params replicate
    "mlp": [("model",)],
    # optimizer-only fallback: when `heads`/`kv_heads` don't divide the model
    # axis, shard the moments/master along head_dim instead
    "head_dim": [("model",)],
}

CACHE_RULES: dict[str, list[tuple[str, ...]]] = {
    **DEFAULT_RULES,
    "seq": [("model",)],  # sequence-sharded KV cache for decode
    "kv_heads": [],  # 8 kv heads rarely divide a 16-way model axis
    "heads": [],
}


class PartitionSpec(tuple):
    """The reference's ``jax.sharding.PartitionSpec``: one entry per tensor
    dim, each ``None`` (replicated), a mesh axis name, or a tuple of names
    (the dim split over their product, the first one outermost)."""

    def __new__(cls, *entries: None | str | tuple[str, ...]):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh, with no devices (the reference's
    ``jax.sharding.AbstractMesh``): ``shape`` maps each name to its size."""

    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def axis_names(mesh: Any) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh: Any) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def batch_axes(mesh: Any) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def data_pspec(mesh: Any, rank: int, dim0: int | None = None) -> PartitionSpec:
    """Batch-sharded spec for inputs: dim 0 over pod×data, rest replicated.

    With ``dim0`` given, falls back through shorter axis prefixes (then full
    replication) when the batch does not divide.
    """
    ax = list(batch_axes(mesh))
    sizes = axis_sizes(mesh)
    if dim0 is not None:
        while ax and dim0 % math.prod(sizes[a] for a in ax) != 0:
            ax.pop(0)  # drop "pod" first, then "data"
    if not ax:
        return P(*([None] * rank))
    return P(tuple(ax) if len(ax) > 1 else ax[0], *([None] * (rank - 1)))


def spec_for(
    axes: tuple[str | None, ...] | None,
    shape: tuple[int, ...],
    mesh: Any,
    rules: Rules = DEFAULT_RULES,
) -> PartitionSpec:
    """Map one tensor's logical axes to a PartitionSpec on ``mesh``."""
    if axes is None:
        return P()
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    entries: list[Any] = []
    for dim, name in enumerate(axes):
        if dim >= len(shape):
            break
        chosen = None
        for cand in rules.get(name, []) if name is not None else []:
            cand = tuple(a for a in cand if a in sizes)
            if not cand or any(a in used for a in cand):
                continue
            factor = math.prod(sizes[a] for a in cand)
            if factor > 1 and shape[dim] % factor == 0:
                chosen = cand
                break
        if chosen:
            used.update(chosen)
            entries.append(chosen if len(chosen) > 1 else chosen[0])
        else:
            entries.append(None)
    while len(entries) < len(shape):
        entries.append(None)
    return P(*entries)


def entry_axes(entry: None | str | Sequence[str]) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements_for(spec: Sequence, mesh: Any) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim an entry of tensor dim ``d`` names, ``Replicate()`` elsewhere.
    Raises for an entry whose axes are not in mesh order, or that names an
    axis twice or one the mesh lacks."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out: list = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r}, not in mesh {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(
                f"spec entry {axes} of dim {d} is not in mesh order {names}: DTensor nests "
                "a dim's shards in mesh-dim order, so this order has no placement")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims of {tuple(spec)}")
            out[i] = Shard(d)
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``);
    ``placements`` are its DTensor placements."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> list:
        return placements_for(self.spec, self.mesh)

    def record(self) -> ShardingRecord:
        """The CMI's sharding record, as the reference writes it."""
        return ShardingRecord(
            mesh_shape=[axis_sizes(self.mesh)[a] for a in axis_names(self.mesh)],
            mesh_axes=list(axis_names(self.mesh)),
            pspec=[None if e is None else (e if isinstance(e, str) else list(e))
                   for e in self.spec],
        )

    def shard_index(self, shape: Sequence[int], coord: Sequence[int]) -> tuple:
        """``((start, stop), ...)`` of the block the device at mesh
        coordinate ``coord`` holds (JAX's ``addressable_shards`` index)."""
        names, sizes = axis_names(self.mesh), axis_sizes(self.mesh)
        at = dict(zip(names, coord))
        out = []
        for d, n in enumerate(shape):
            entry = self.spec[d] if d < len(self.spec) else None
            block, parts = 0, 1
            for a in entry_axes(entry):
                block, parts = block * sizes[a] + at[a], parts * sizes[a]
            if n % parts:
                raise ValueError(f"dim {d} of size {n} does not split {parts} ways")
            out.append((block * (n // parts), (block + 1) * (n // parts)))
        return tuple(out)

    def coords(self):
        """Every mesh coordinate, in row-major order."""
        sizes = axis_sizes(self.mesh)
        return itertools.product(*(range(sizes[a]) for a in axis_names(self.mesh)))


def replicated(mesh: Any) -> NamedSharding:
    return NamedSharding(mesh, P())


def sharding_for(axes, shape, mesh: Any, rules: Rules = DEFAULT_RULES) -> NamedSharding:
    return NamedSharding(mesh, spec_for(axes, tuple(shape), mesh, rules))


def tree_shardings(axes_tree: Any, shape_tree: Any, mesh: Any, rules: Rules = DEFAULT_RULES):
    """Parallel (axes, shapes) trees -> tree of :class:`NamedSharding`
    (each a mesh, a spec and its placements).

    ``axes_tree`` leaves are tuples of logical names (a leaf per tensor);
    ``shape_tree`` leaves are anything with ``.shape`` (tensors or
    TensorSpecs). Axes leaves are tuples, so the *shape* tree is flattened
    and the axes are looked up by path.
    """
    flat_shapes, treedef = flatten_with_paths(shape_tree)
    flat_axes, _ = flatten_with_paths(
        axes_tree, is_leaf=lambda x: x is None or isinstance(x, tuple))
    out = {}
    for path, shp in flat_shapes.items():
        shape = tuple(shp.shape) if hasattr(shp, "shape") else ()
        out[path] = sharding_for(flat_axes.get(path), shape, mesh, rules)
    return unflatten_from_paths(treedef, out)


# ---------------------------------------------------------------------------
# DTensors placed by a NamedSharding
# ---------------------------------------------------------------------------


def mesh_device(mesh: Any) -> torch.device:
    """This rank's device of ``mesh``: its current CUDA device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_coordinate(mesh: Any) -> tuple[int, ...]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return tuple(coord)


def from_local(local: torch.Tensor, shape: Sequence[int], sharding: NamedSharding):
    """A DTensor of global ``shape`` whose block on this rank is ``local``,
    carrying ``sharding`` (its spec is what a CMI records)."""
    from torch.distributed.tensor import DTensor

    shape = tuple(int(n) for n in shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    dt = DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False,
                            shape=torch.Size(shape), stride=stride)
    dt._repro_sharding = sharding
    return dt


def local_block(full: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of a tensor every rank holds whole (no
    communication)."""
    index = sharding.shard_index(full.shape, mesh_coordinate(sharding.mesh))
    return full[tuple(slice(a, b) for a, b in index)]


def distribute(full: torch.Tensor, sharding: NamedSharding):
    """A tensor that every rank holds whole, placed by ``sharding``: each
    rank keeps its own block (a copy on the mesh's device)."""
    local = local_block(full, sharding).to(mesh_device(sharding.mesh), copy=True)
    return from_local(local.contiguous(), full.shape, sharding)


def sharding_of(t: Any) -> NamedSharding | None:
    """The :class:`NamedSharding` a DTensor was placed with (one rebuilt
    from its placements, full length, where it was placed otherwise);
    ``None`` for anything else."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return None
    sh = getattr(t, "_repro_sharding", None)
    if sh is not None:
        return sh
    names = axis_names(t.device_mesh)
    entries: list[list[str]] = [[] for _ in t.shape]
    for name, pl in zip(names, t.placements):
        if isinstance(pl, Shard):
            entries[pl.dim].append(name)
    spec = P(*(None if not e else (e[0] if len(e) == 1 else tuple(e)) for e in entries))
    return NamedSharding(t.device_mesh, spec)


def redistribute(t: Any, sharding: NamedSharding):
    """``t`` (a DTensor, or a tensor every rank holds whole) placed by
    ``sharding``; a DTensor already so placed is returned as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return distribute(t, sharding)
    cur = sharding_of(t)
    if cur.mesh is sharding.mesh and list(cur.placements) == list(sharding.placements):
        t._repro_sharding = sharding
        return t
    if t.device_mesh is not sharding.mesh:
        return distribute(t.full_tensor(), sharding)
    out = t.redistribute(sharding.mesh, sharding.placements)
    out = from_local(out.to_local().contiguous(), t.shape, sharding)
    return out


def place_tree(tree: Any, shardings: Any) -> Any:
    """Every tensor leaf of ``tree`` placed by the parallel ``shardings``
    tree (the reference's ``tree_map(jax.device_put, tree, shardings)``)."""
    flat, treedef = flatten_with_paths(tree)
    sh, _ = flatten_with_paths(shardings)
    return unflatten_from_paths(
        treedef, {k: redistribute(v, sh[k]) if isinstance(v, torch.Tensor) else v
                  for k, v in flat.items()})
