"""CMI: the Checkpoint Memory Image as a tree of tensors.

The CMI holds *only application state* — a tree of tensors, arrays and
scalars — plus sharding records (the JAX package writes them; the port
writes ``None``, one device holding the whole tensor). The runtime is
reconstructed at the destination, as DMTCP's restart script reloads local
shared libraries.

Restore onto a device
---------------------
``device_resolver(device)`` places every array on one device, whatever
sharding record the CMI carries: a CMI the JAX package wrote on a mesh
restores onto the one card. Sharded restores (``DeviceMesh``) come with the
distributed slice of the port.
"""

from __future__ import annotations

import time
from typing import Any

import torch

from repro_torch.checkpoint.format import ShardingRecord, dtype_to_str, tensor_to_storage
from repro_torch.checkpoint.serializer import (
    HostShards,
    SaveOptions,
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
    updates never reach the snapshot.
    """

    def snap(t: Any) -> Any:
        if not isinstance(t, torch.Tensor):
            return t
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


def restore_cmi(
    store_root,
    name: str,
    *,
    device: torch.device | str | None = None,
    validate_crc: bool = True,
    io_threads: int = 0,
) -> tuple[Any, Any]:
    """Restore a CMI onto ``device`` (default: the CUDA card).

    Returns ``(state, manifest)``. ``io_threads`` sizes the concurrent-read
    pool (0 = min(8, cpu_count), 1 = serial).
    """
    return load_checkpoint(
        store_root, name, devices=device_resolver(device),
        validate_crc=validate_crc, io_threads=io_threads,
    )
