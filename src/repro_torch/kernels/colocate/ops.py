"""K2: angular nearest-neighbour match (VIIRS pixel → CrIS field of view).

Port of the Pallas kernel ``repro/kernels/colocate`` (wrapper
``ops.colocate_match``, oracle ``ref.colocate_match_ref``): for each unit
vector ``u[i]`` the best fp32 cosine against ``los[j]`` and its index, ties
to the lowest index.

:func:`colocate_match` runs :func:`colocate_match_plain` for CPU tensors and
the CUDA kernel ``csrc/colocate.cu`` for CUDA tensors. Both compute each
dot as the fused multiply-add chain ``fma(u2, l2, fma(u1, l1, u0 * l0))`` —
the arithmetic XLA's CPU backend gives the JAX package's K=3 dot — so the
kernel and the plain version agree bitwise on the card, and the plain
version agrees bitwise with the JAX package on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

PLAIN_BLOCK_ROWS = 4096  # rows per score block: its float64 temporaries stay ~0.4 GB each at M=12,960


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``fma(a, b, c)`` (one rounding of a*b + c).

    PyTorch has no fused multiply-add op, so it is built from float64 ops:
    the product of two float32 values is exact in float64, the sum is
    rounded once to float64 with its error kept exactly (TwoSum), and the
    final rounding to float32 is corrected where rounding twice would
    differ from rounding once — when the float64 sum lies exactly halfway
    between two float32 values and the error says which way the exact
    value lies.
    """
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    # halfway between two float32s: the 29 mantissa bits below float32
    # precision read 1000...0
    tie = ((s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000) & (err != 0)
    up = tie & (err > 0) & (r.double() < s)
    down = tie & (err < 0) & (r.double() > s)
    inf = torch.full_like(r, float("inf"))
    r = torch.where(up, torch.nextafter(r, inf), r)
    return torch.where(down, torch.nextafter(r, -inf), r)


def _check(u: torch.Tensor, los: torch.Tensor) -> None:
    if u.dim() != 2 or los.dim() != 2 or u.shape[1] != 3 or los.shape[1] != 3:
        raise ValueError(f"need u[N,3] and los[M,3], got {tuple(u.shape)} {tuple(los.shape)}")
    if u.dtype != torch.float32 or los.dtype != torch.float32:
        raise ValueError(f"need float32 inputs, got {u.dtype} {los.dtype}")


def colocate_match_plain(
    u: torch.Tensor, los: torch.Tensor, *, block_rows: int = PLAIN_BLOCK_ROWS
) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx int32[N], cos float32[N]) on the inputs' device, in row blocks."""
    _check(u, los)
    n, m = u.shape[0], los.shape[0]
    idx = torch.zeros(n, dtype=torch.int32, device=u.device)
    cos = torch.full((n,), float("-inf"), dtype=torch.float32, device=u.device)
    if m == 0:
        return idx, cos
    l0, l1, l2 = los[:, 0], los[:, 1], los[:, 2]
    for r0 in range(0, n, block_rows):
        ub = u[r0:r0 + block_rows]
        s = ub[:, 0:1] * l0
        s = fma_f32(ub[:, 1:2], l1, s)
        s = fma_f32(ub[:, 2:3], l2, s)
        best, arg = s.max(dim=1)  # first maximum on ties
        cos[r0:r0 + block_rows] = best
        idx[r0:r0 + block_rows] = arg.to(torch.int32)
    return idx, cos


@functools.cache
def _kernel():
    fn = _build.load("colocate").colocate_match
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def colocate_match(u: torch.Tensor, los: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx int32[N], cos float32[N]) — the plain version on the CPU, the
    kernel on CUDA."""
    _check(u, los)
    if u.device.type == "cpu" and los.device.type == "cpu":
        return colocate_match_plain(u, los)
    if u.device != los.device or u.device.type != "cuda":
        raise ValueError(f"colocate_match needs both tensors on one CUDA device or on "
                         f"the CPU, got {u.device} and {los.device}")
    n, m = u.shape[0], los.shape[0]
    if n >= 2**31 or m >= 2**31:
        raise ValueError(f"colocate_match takes fewer than 2**31 rows, got N={n} M={m}")
    u = u.detach().contiguous()
    los = los.detach().contiguous()
    idx = torch.empty(n, dtype=torch.int32, device=u.device)
    cos = torch.empty(n, dtype=torch.float32, device=u.device)
    if n:
        with torch.cuda.device(u.device):  # the launch goes to the current device
            err = _kernel()(u.data_ptr(), los.data_ptr(), n, m, idx.data_ptr(), cos.data_ptr(),
                            torch.cuda.current_stream(u.device).cuda_stream)
        if err:
            raise RuntimeError(f"colocate kernel launch failed: CUDA error {err}")
        colocate_match.launches += 1
    return idx, cos


colocate_match.launches = 0  # kernel launches since the last reset
