"""The chunked linear recurrence as CUDA kernels, forward and backward.

Replaces no Pallas kernel: the JAX package's ``chunked_linear_recurrence``
(``repro/models/ssm.py``) is plain jnp. Its plain PyTorch version is
``models.ssm._recurrence``, which ``models.ssm.chunked_linear_recurrence``
runs for CPU tensors; for CUDA tensors it calls :func:`linear_recurrence`
here, which launches the kernels of ``csrc/linear_recurrence.cu`` or
raises. The kernels compute the same function in float32 arithmetic: a
fixed number of launches a call (three forward, three backward) whatever
the number of chunks, no Q×Q tile in device memory, and sums in a fixed
order, so a call is bitwise repeatable. The source's header says what
bounds them and how they are laid out.

Both directions are operators of their own (``torch.library.custom_op``):
``repro_torch::linear_recurrence_fwd`` returns, beside ``y`` and the final
state, each chunk's entering state and each chunk's total log-decay, which
:class:`LinearRecurrence` saves for ``repro_torch::linear_recurrence_bwd``.
Both raise unless every tensor is on one CUDA device and their operands
are as :func:`operands` makes them, which the callers do first. Under
``FakeTensorMode`` (the dry run) their fake implementations refuse the
shapes the kernels refuse and give the outputs' shapes, and ``torch.utils.flop_counter`` counts them as the plain
version's products (``launch.train.recurrence_flops``; twice that
backward).

Shapes: q, k (B, S, H, N), v (B, S, H, P), log a (B, S, H), an initial
state (B, H, N, P); chunks of ``min(chunk, S)`` positions, at most
:data:`KERNEL_MAX_CHUNK`. q, k and v are read in bfloat16 where all three
are, else in float32; gradients come back in each input's dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch import spans
from repro_torch.kernels import _build

KERNEL_MAX_CHUNK = 128
SCAN_TILE = 1024  # state elements a block of the scans carries (kScanTile)
SCAN_WARPS = 8  # each writes one share of a chunk's d(total log-decay)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _dims(q, k, v, log_a, initial_state, chunk: int) -> tuple[int, ...]:
    """``(B, S, H, N, P, Q, nc)``; raises on shapes the function does not
    take or the kernels cannot launch."""
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"need q, k (B,S,H,N) and v (B,S,H,P), got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    b, s, h, n = q.shape
    p = v.shape[3]
    if log_a.shape != (b, s, h):
        raise ValueError(f"log_a must be (B,S,H) = {(b, s, h)}, got {tuple(log_a.shape)}")
    if initial_state is not None and initial_state.shape != (b, h, n, p):
        raise ValueError(f"initial_state must be (B,H,N,P) = {(b, h, n, p)}, "
                         f"got {tuple(initial_state.shape)}")
    if min(b, s, h, n, p) < 1 or chunk < 1:
        raise ValueError(f"empty recurrence: q{tuple(q.shape)} v{tuple(v.shape)} chunk {chunk}")
    cq = min(chunk, s)
    if cq > KERNEL_MAX_CHUNK or b * h > 65535:
        raise ValueError(f"the CUDA kernels take chunks up to {KERNEL_MAX_CHUNK} and B·H up to "
                         f"65535, got chunk {cq}, B {b}, H {h}")
    return b, s, h, n, p, cq, -(-s // cq)


def operands(q, k, v, log_a, initial_state=None):
    """What the operators take: q, k and v dense in one dtype the kernels
    read (bfloat16 where all three are, else float32), log a and the
    initial state dense in float32; a copy only of what is not so already.
    Made outside the operators, so that the dry run, which sees an operator
    as one call, counts these copies as the card holds them."""
    dt = q.dtype if q.dtype == k.dtype == v.dtype and q.dtype in _DTYPES else torch.float32
    q, k, v = (t.to(dt).contiguous() for t in (q, k, v))
    init = None if initial_state is None else initial_state.float().contiguous()
    return q, k, v, log_a.float().contiguous(), init


def _check_operands(q, k, v, *f32) -> int:
    """The kernels' code for the dtype of q, k and v; raises unless the
    operands are as :func:`operands` makes them (``f32``: the float32 ones,
    None where absent)."""
    ts = (q, k, v) + tuple(t for t in f32 if t is not None)
    if (not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPES
            or any(t.dtype != torch.float32 for t in ts[3:])
            or not all(t.is_contiguous() for t in ts)):
        raise ValueError("the recurrence's operators take dense q, k and v in one of float32 "
                         "and bfloat16 and the rest dense in float32 (see operands), got "
                         f"{[(t.dtype, t.is_contiguous()) for t in ts]}")
    return _DTYPES[q.dtype]


@functools.cache
def _kernel(entry: str):
    lib = _build.load("linear_recurrence")
    fn = getattr(lib, entry)
    pointers = 9 if entry == "linear_recurrence_fwd" else 16
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _call(entry: str, device, pointers: list, dims: list) -> None:
    with torch.cuda.device(device):  # the launches go to the current device
        err = _kernel(entry)(*pointers, *dims, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


def _check_device(ts) -> None:
    devices = {t.device for t in ts if t is not None}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"the recurrence's kernels need every tensor on one CUDA device, got "
                         f"{sorted(str(d) for d in devices)}")


def _fwd_outputs(q, v, chunk: int):
    """Empty ``(y, final state, entering states, totals)``, float32."""
    b, s, h, n = q.shape
    p = v.shape[3]
    nc = -(-s // min(chunk, s))
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.empty((b, s, h, p), **f32), torch.empty((b, h, n, p), **f32),
            torch.empty((b, h, nc, n, p), **f32), torch.empty((b, h, nc), **f32))


@torch.library.custom_op("repro_torch::linear_recurrence_fwd", mutates_args=())
def linear_recurrence_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          log_a: torch.Tensor, initial_state: Optional[torch.Tensor],
                          chunk: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """``(y (B,S,H,P), final state (B,H,N,P), each chunk's entering state
    (B,H,nc,N,P), each chunk's total log-decay (B,H,nc))``, float32."""
    _check_device((q, k, v, log_a, initial_state))
    b, s, h, n, p, cq, _ = _dims(q, k, v, log_a, initial_state, chunk)
    code = _check_operands(q, k, v, log_a, initial_state)
    y, final, states, tot = _fwd_outputs(q, v, chunk)
    _call("linear_recurrence_fwd", q.device,
          [q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(),
           None if initial_state is None else initial_state.data_ptr(), y.data_ptr(),
           states.data_ptr(), final.data_ptr(), tot.data_ptr()], [b, s, h, n, p, cq, code])
    linear_recurrence.launches += 1
    spans.count("linear_recurrence.launches", 1)
    return y, final, states, tot


@linear_recurrence_fwd.register_fake
def _linear_recurrence_fwd_fake(q, k, v, log_a, initial_state, chunk):
    _dims(q, k, v, log_a, initial_state, chunk)  # the dry run refuses what the card would
    _check_operands(q, k, v, log_a, initial_state)
    return _fwd_outputs(q, v, chunk)


@torch.library.custom_op("repro_torch::linear_recurrence_bwd", mutates_args=())
def linear_recurrence_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          log_a: torch.Tensor, states: torch.Tensor, final: torch.Tensor,
                          tot: torch.Tensor, dy: torch.Tensor, dfinal: torch.Tensor,
                          chunk: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                               torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv, d log_a, d initial_state, each chunk's outgoing state
    gradient (B,H,nc,N,P))``, float32, from the inputs (as :func:`operands`
    makes them), what :func:`linear_recurrence_fwd` returned beside ``y``
    and the float32 gradients of ``y`` and of the final state. The last is
    returned so that the dry run counts it; only the warps' shares of each
    chunk's d(total log-decay), B·H·nc·8·⌈N·P/1024⌉ floats, stay inside."""
    _check_device((q, k, v, log_a, states, final, tot, dy, dfinal))
    b, s, h, n, p, cq, nc = _dims(q, k, v, log_a, None, chunk)
    if (states.shape != (b, h, nc, n, p) or final.shape != (b, h, n, p) or tot.shape != (b, h, nc)
            or dy.shape != (b, s, h, p) or dfinal.shape != final.shape):
        raise ValueError(f"saved or incoming shapes do not match q{tuple(q.shape)} "
                         f"v{tuple(v.shape)}: states{tuple(states.shape)} final"
                         f"{tuple(final.shape)} tot{tuple(tot.shape)} dy{tuple(dy.shape)} "
                         f"dfinal{tuple(dfinal.shape)}")
    code = _check_operands(q, k, v, log_a, states, final, tot, dy, dfinal)
    dq, dk, dv, dla, dinit, g = _bwd_outputs(q, v, log_a, states)
    nparts = -(-n * p // SCAN_TILE) * SCAN_WARPS
    partial = torch.empty((b * h * nc * nparts,), dtype=torch.float32, device=q.device)
    _call("linear_recurrence_bwd", q.device,
          [q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(), states.data_ptr(),
           final.data_ptr(), tot.data_ptr(), dy.data_ptr(), dfinal.data_ptr(), g.data_ptr(),
           partial.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dla.data_ptr(),
           dinit.data_ptr()], [b, s, h, n, p, cq, code])
    linear_recurrence.bwd_launches += 1
    spans.count("linear_recurrence.launches", 1)
    return dq, dk, dv, dla, dinit, g


def _bwd_outputs(q, v, log_a, states):
    b, s, h, n = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.empty(q.shape, **f32), torch.empty(q.shape, **f32), torch.empty(v.shape, **f32),
            torch.empty(log_a.shape, **f32), torch.empty((b, h, n, v.shape[3]), **f32),
            torch.empty(states.shape, **f32))


@linear_recurrence_bwd.register_fake
def _linear_recurrence_bwd_fake(q, k, v, log_a, states, final, tot, dy, dfinal, chunk):
    _dims(q, k, v, log_a, None, chunk)
    _check_operands(q, k, v, log_a, states, final, tot, dy, dfinal)
    return _bwd_outputs(q, v, log_a, states)


def _forward_flops(q_shape, v_shape, chunk: int) -> int:
    """The plain version's products (``launch.train.recurrence_flops``): a
    token and head of the sequence padded to whole chunks of Q, the Q×Q
    scores and outputs (2 Q (N + P)) and the N×P carry and inter-chunk
    terms (2 · 2 N P)."""
    b, s, h, n = q_shape
    p = v_shape[3]
    cq = min(chunk, s)
    return 2 * b * -(-s // cq) * cq * h * (cq * (n + p) + 2 * n * p)


@register_flop_formula(torch.ops.repro_torch.linear_recurrence_fwd)
def _linear_recurrence_fwd_flops(q_shape, k_shape, v_shape, log_a_shape, init_shape, chunk,
                                 *args, out_shape=None, **kwargs) -> int:
    return _forward_flops(q_shape, v_shape, chunk)


@register_flop_formula(torch.ops.repro_torch.linear_recurrence_bwd)
def _linear_recurrence_bwd_flops(q_shape, k_shape, v_shape, log_a_shape, states_shape,
                                 final_shape, tot_shape, dy_shape, dfinal_shape, chunk, *args,
                                 out_shape=None, **kwargs) -> int:
    """Twice the forward's: each product's two gradients, as autograd
    differentiates the plain version."""
    return 2 * _forward_flops(q_shape, v_shape, chunk)


class LinearRecurrence(torch.autograd.Function):
    """The recurrence under autograd: the forward operator, whose entering
    states and totals are saved, and the backward operator."""

    @staticmethod
    def forward(ctx, q, k, v, log_a, initial_state, chunk: int):
        y, final, states, tot = linear_recurrence_fwd(*operands(q, k, v, log_a, initial_state),
                                                      chunk)
        ctx.save_for_backward(q, k, v, log_a, states, final, tot)  # q, k, v as they came
        ctx.chunk = chunk
        ctx.init_dtype = None if initial_state is None else initial_state.dtype
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        q, k, v, log_a, states, final, tot = ctx.saved_tensors
        qd, kd, vd, la, _ = operands(q, k, v, log_a)
        dq, dk, dv, dla, dinit, _ = linear_recurrence_bwd(
            qd, kd, vd, la, states, final, tot, dy.float().contiguous(),
            dfinal.float().contiguous(), ctx.chunk)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dla.to(log_a.dtype),
                None if ctx.init_dtype is None else dinit.to(ctx.init_dtype), None)


def linear_recurrence(
    q: torch.Tensor,  # (B, S, H, N)
    k: torch.Tensor,  # (B, S, H, N)
    v: torch.Tensor,  # (B, S, H, P)
    log_a: torch.Tensor,  # (B, S, H) log-decay, <= 0
    initial_state: torch.Tensor | None = None,  # (B, H, N, P)
    *,
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y (B, S, H, P), final state (B, H, N, P))``, float32, by the CUDA
    kernels; the forward operator raises unless every tensor is on one CUDA
    device. Where an input requires grad (and grad mode is on), through
    :class:`LinearRecurrence`."""
    ins = (q, k, v, log_a, initial_state)
    chunk = int(chunk)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ins):
        return LinearRecurrence.apply(q, k, v, log_a, initial_state, chunk)
    return linear_recurrence_fwd(*operands(*ins), chunk)[:2]


linear_recurrence.launches = 0  # forward launches (three kernels each) since the last reset
linear_recurrence.bwd_launches = 0  # backward launches (three kernels each)
