"""CMI: the Checkpoint Memory Image as a tree of tensors.

The CMI holds *only application state* — a tree of tensors, arrays and
scalars — plus sharding records: a DTensor on a ``DeviceMesh`` records its
mesh and PartitionSpec as the JAX package records a ``NamedSharding``
(``ShardingRecord``), and a tensor on one device records ``None``. The
runtime is reconstructed at the destination, as DMTCP's restart script
reloads local shared libraries.

Restore onto a device
---------------------
``device_resolver(device)`` places every array on one device, whatever
sharding record the CMI carries: a CMI written on a mesh restores onto
one card.

Elastic restore
---------------
``mesh_resharding_resolver(mesh)`` re-maps each saved array's
PartitionSpec onto the *destination* mesh by axis name, dropping axes the
new mesh lacks and falling back to replication when a dimension no longer
divides (the reference's resolver, copied). ``restore_cmi(mesh=...)``
places every array as a DTensor by it, each rank reading only the chunks
that meet its own shard: a CMI published on a 2×2 mesh resumes on 2×1
after a spot reclaim.
"""

from __future__ import annotations

import math
import time
from typing import Any, Mapping

import torch

from repro_torch.checkpoint.format import ShardingRecord, dtype_to_str, tensor_to_storage
from repro_torch.checkpoint.serializer import (
    HostShards,
    SaveOptions,
    _is_dtensor,
    dtensor_to_host,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.utils import logger, resolve_device, tree_map


# ---------------------------------------------------------------------------
# host snapshot (synchronous device→host; serialization can then be async)
# ---------------------------------------------------------------------------


def snapshot_to_host(tree: Any) -> Any:
    """Copy every tensor leaf to the host as a :class:`HostShards`.

    Each copy is ``tensor.cpu()`` in the storage dtype, one after another on
    the current stream (pinned staging buffers and copies that overlap
    compute are later work); a CPU tensor is copied too, so later in-place
    updates never reach the snapshot. A DTensor leaf is gathered to rank 0
    (``serializer.dtensor_to_host``: one copy per distinct shard and the
    sharding record), so with DTensor leaves every rank of the group calls
    this, in the same tree order, and only rank 0's snapshot holds them
    (other ranks get ``None`` leaves).
    """

    def snap(t: Any) -> Any:
        if not isinstance(t, torch.Tensor):
            return t
        if _is_dtensor(t):
            return dtensor_to_host(t)
        shape = tuple(int(d) for d in t.shape)
        host = tensor_to_storage(t)  # a copy for CUDA, a view of a CPU tensor
        if t.device.type == "cpu":
            host = host.copy()
        return HostShards(shape, dtype_to_str(t.dtype), [(tuple((0, d) for d in shape), host)],
                          None)

    return tree_map(snap, tree)


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------


def save_cmi(
    store_root,
    name: str,
    state: Any,
    *,
    step: int = 0,
    meta: dict | None = None,
    options: SaveOptions | None = None,
) -> Any:
    """Serialize ``state`` (device or host-snapshot tree) as a committed CMI."""
    t0 = time.perf_counter()
    meta = dict(meta or {})
    meta.setdefault("saved_at", time.time())
    manifest = save_checkpoint(store_root, name, state, step=step, meta=meta, options=options)
    logger.debug("save_cmi %s took %.3fs", name, time.perf_counter() - t0)
    return manifest


def device_resolver(device: torch.device | str | None):
    """Resolver placing every array on ``device`` (None: the CUDA card).

    The saved sharding record is read and ignored: one device holds the
    whole array.
    """
    dev = resolve_device(device)

    def resolver(
        path: str, shape: tuple[int, ...], dtype: str, rec: ShardingRecord | None
    ) -> torch.device:
        return dev

    return resolver


def mesh_resharding_resolver(
    mesh: Any,
    overrides: Mapping[str, Any] | None = None,
    *,
    default_replicated: bool = True,
):
    """Build a sharding resolver that re-maps saved specs onto ``mesh``.

    For each array: an explicit override wins; otherwise the saved
    PartitionSpec is filtered to axis names present in ``mesh`` with
    per-dimension divisibility checks (non-dividing dims are replicated).
    With ``mesh=None`` the resolver gives ``None`` (no sharding).
    """
    from repro_torch.distributed.sharding import NamedSharding, P, axis_sizes

    sizes = axis_sizes(mesh) if mesh is not None else {}

    def resolver(path: str, shape: tuple[int, ...], dtype: str, rec: ShardingRecord | None):
        if overrides is not None and path in overrides:
            return overrides[path]
        if mesh is None:
            return None
        if rec is None:
            return NamedSharding(mesh, P()) if default_replicated else None
        entries = []
        for dim, entry in enumerate(rec.pspec):
            if entry is None:
                entries.append(None)
                continue
            names = entry if isinstance(entry, (list, tuple)) else [entry]
            kept = [n for n in names if n in sizes]
            factor = math.prod(sizes[n] for n in kept) if kept else 1
            if not kept or dim >= len(shape) or shape[dim] % factor != 0:
                entries.append(None)
            else:
                entries.append(tuple(kept) if len(kept) > 1 else kept[0])
        entries = entries[: len(shape)]  # pad/trim to rank
        while len(entries) < len(shape):
            entries.append(None)
        return NamedSharding(mesh, P(*entries))

    return resolver


def restore_cmi(
    store_root,
    name: str,
    *,
    device: torch.device | str | None = None,
    mesh: Any = None,
    shardings: Mapping[str, Any] | None = None,
    validate_crc: bool = True,
    io_threads: int = 0,
) -> tuple[Any, Any]:
    """Restore a CMI onto ``device`` (default: the CUDA card), or onto a
    (possibly different) ``mesh``.

    Returns ``(state, manifest)``. With ``mesh``, arrays land as DTensors
    placed by the remapped saved specs; with ``shardings`` (flat path ->
    ``NamedSharding``), those win. ``io_threads`` sizes the concurrent-read
    pool (0 = min(8, cpu_count), 1 = serial).
    """
    resolver = (mesh_resharding_resolver(mesh, overrides=shardings) if mesh is not None
                else shardings)
    return load_checkpoint(
        store_root, name, devices=None if mesh is not None else device_resolver(device),
        shardings=resolver, validate_crc=validate_crc, io_threads=io_threads,
    )
