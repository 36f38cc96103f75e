"""Incremental (delta) CMIs — paper §Q3.

"Another solution is to save the CMIs incrementally by saving only deltas of
each consecutive checkpoint."

Two cooperating pieces:

* :class:`DeltaTracker` — decides, per job, which published CMI the next one
  should delta against. Chains are capped (``full_every``) so restores never
  replay long chains and GC can reclaim ancestors.
* :func:`device_changed_hints` — runs the delta_encode kernel (K1,
  ``repro_torch.kernels.delta_encode``) over (previous, current) trees to
  produce per-chunk "changed" bitmaps where the tensors live, so the
  serializer never copies a block the device proved unchanged to the host.

The chunk grid here must match the serializer's (axis-0 row blocks of
``chunk_bytes``) — both call :func:`repro_torch.checkpoint.serializer._chunk_rows`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.atomic import is_committed
from repro_torch.checkpoint.serializer import _chunk_rows
from repro_torch.kernels.delta_encode.ops import changed_blocks
from repro_torch.utils import flatten_with_paths, logger, numpy_to_tensor


@dataclass
class DeltaPolicy:
    enabled: bool = True
    full_every: int = 8  # emit a full (chain-resetting) CMI every N publishes
    keep_last: int = 2  # CMIs retained by job-store GC (plus chain ancestors)


class DeltaTracker:
    def __init__(self, policy: DeltaPolicy):
        self.policy = policy
        self._last: dict[str, str] = {}  # job_id -> last published CMI name
        self._chain_len: dict[str, int] = {}

    def parent_for(self, job_id: str, jobstore) -> str | None:
        if not self.policy.enabled:
            return None
        last = self._last.get(job_id)
        if last is None:
            return None
        if self._chain_len.get(job_id, 0) >= self.policy.full_every - 1:
            logger.debug("delta chain for job %s reset (full_every)", job_id)
            return None
        # parent must still exist (GC keeps chain ancestors of kept CMIs,
        # but a restart may reference a since-GC'd name)
        if not is_committed(jobstore.cmi_root(job_id) / last):
            return None
        return last

    def record_published(self, job_id: str, name: str) -> None:
        prev = self._last.get(job_id)
        self._last[job_id] = name
        self._chain_len[job_id] = 0 if prev is None else (
            0 if self._chain_len.get(job_id, 0) >= self.policy.full_every - 1
            else self._chain_len.get(job_id, 0) + 1
        )


# ---------------------------------------------------------------------------
# on-device change detection
# ---------------------------------------------------------------------------


def _as_tensor(x: Any, like: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return numpy_to_tensor(np.asarray(x), like.device if isinstance(like, torch.Tensor) else "cpu")


def device_changed_hints(
    prev_tree: Any, new_tree: Any, *, chunk_bytes: int = 16 << 20
) -> dict[str, np.ndarray]:
    """Per-array per-chunk "changed" bitmaps, computed where the tensors live.

    CUDA tensors go through the K1 kernel, CPU tensors and numpy arrays
    through its plain version. Arrays whose shape or dtype differ between
    the trees (or that are new) get no hint, so the serializer hashes them.
    """
    prev_flat, _ = flatten_with_paths(prev_tree)
    new_flat, _ = flatten_with_paths(new_tree)
    hints: dict[str, np.ndarray] = {}
    for path, new_leaf in new_flat.items():
        if not isinstance(new_leaf, (torch.Tensor, np.ndarray)):
            continue
        prev_leaf = prev_flat.get(path)
        if not isinstance(prev_leaf, (torch.Tensor, np.ndarray)):
            continue
        new_t = _as_tensor(new_leaf, prev_leaf)
        prev_t = _as_tensor(prev_leaf, new_t)
        if tuple(prev_t.shape) != tuple(new_t.shape) or prev_t.dtype != new_t.dtype:
            continue  # no hint -> serializer hashes (and likely rewrites)
        rows = _chunk_rows(tuple(new_t.shape), new_t.element_size(), chunk_bytes)
        hints[path] = changed_blocks(prev_t, new_t, rows).cpu().numpy()
    return hints
