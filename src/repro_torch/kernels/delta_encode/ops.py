"""K1: per-chunk changed bitmap for incremental CMIs (paper §Q3).

Port of the Pallas kernel ``repro/kernels/delta_encode`` (wrapper
``ops.changed_blocks``, oracle ``ref.changed_blocks_ref``). The chunk grid
is the serializer's: axis-0 blocks of ``rows`` rows (``_chunk_rows``); a
0-d array is one block, and so is an empty one. The comparison is bitwise
(raw bytes), so NaN payloads and -0.0/+0.0 count as changes.

:func:`changed_blocks` runs :func:`changed_blocks_plain` for CPU tensors
and the CUDA kernel ``csrc/delta_encode.cu`` for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.utils import ceil_div


def _check(old: torch.Tensor, new: torch.Tensor, rows: int) -> tuple[int, int]:
    """Validate the pair; return ``(n0, nblocks)`` of the chunk grid."""
    if tuple(old.shape) != tuple(new.shape):
        raise ValueError(f"shape mismatch {tuple(old.shape)} vs {tuple(new.shape)}")
    if old.dtype != new.dtype:
        raise ValueError(f"dtype mismatch {old.dtype} vs {new.dtype}")
    if rows < 1:
        raise ValueError(f"rows must be >= 1, got {rows}")
    n0 = old.shape[0] if old.dim() else 1
    return n0, max(1, ceil_div(n0, rows))


def _row_bytes(x: torch.Tensor) -> int:
    return math.prod(x.shape[1:]) * x.element_size() if x.dim() else x.element_size()


def changed_blocks_plain(old: torch.Tensor, new: torch.Tensor, rows: int) -> torch.Tensor:
    """bool[nblocks] on the inputs' device: does chunk i differ bitwise?"""
    n0, nblocks = _check(old, new, rows)
    if old.numel() == 0:
        return torch.zeros(nblocks, dtype=torch.bool, device=old.device)
    row_elems = math.prod(old.shape[1:]) if old.dim() else 1

    def as_bytes(x: torch.Tensor) -> torch.Tensor:
        return x.detach().contiguous().reshape(n0, row_elems).view(torch.uint8)

    row_changed = (as_bytes(old) != as_bytes(new)).any(dim=1)  # bool[n0]
    full = (nblocks - 1) * rows
    head = row_changed[:full].reshape(nblocks - 1, rows).any(dim=1)
    return torch.cat([head, row_changed[full:].any().reshape(1)])


@functools.cache
def _kernel():
    fn = _build.load("delta_encode").delta_encode_changed_blocks
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def changed_blocks(old: torch.Tensor, new: torch.Tensor, rows: int) -> torch.Tensor:
    """bool[nblocks] — the plain version on the CPU, the kernel on CUDA."""
    n0, nblocks = _check(old, new, rows)
    if old.device.type == "cpu" and new.device.type == "cpu":
        return changed_blocks_plain(old, new, rows)
    if old.device != new.device or old.device.type != "cuda":
        raise ValueError(f"changed_blocks needs both tensors on one CUDA device or on "
                         f"the CPU, got {old.device} and {new.device}")
    a = old.detach().contiguous()
    b = new.detach().contiguous()
    flags = torch.zeros(nblocks, dtype=torch.int32, device=a.device)
    total = a.numel() * a.element_size()
    if total:
        with torch.cuda.device(a.device):  # the launch goes to the current device
            err = _kernel()(a.data_ptr(), b.data_ptr(), total, rows * _row_bytes(a), nblocks,
                            flags.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream)
        if err:
            raise RuntimeError(f"delta_encode kernel launch failed: CUDA error {err}")
        changed_blocks.launches += 1
    return flags.bool()


changed_blocks.launches = 0  # kernel launches since the last reset
