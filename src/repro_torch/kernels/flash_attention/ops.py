"""K3: GQA flash attention, causal and/or sliding window, and its gradient.

Port of the Pallas kernel ``repro/kernels/flash_attention`` (wrapper
``ops.flash_attention``, kernel ``flash_attention_padded``, oracle
``ref.attention_ref``): online softmax over key tiles with float32 running
``(m, l, acc)``, key positions past ``s_k`` masked, a row with no visible
key exactly 0, the output cast to q's dtype. Query head ``h`` reads kv
head ``h // (H / Hkv)``. v's head dim ``Dv`` may differ from q's and k's
``D`` (MLA: qk 192, v 128); the output is ``(B, H, Sq, Dv)``, and the
scale stays ``1/sqrt(D)``, as the reference's ``blockwise_attention``
computes (the Pallas kernel and its oracle take ``Dv == D`` only).

:func:`flash_attention` calls the operator ``repro_torch::flash_attention_fwd``
(:func:`flash_attention_fwd`, a ``torch.library.custom_op``), whose CPU
implementation is :func:`flash_attention_plain` and whose CUDA one launches
a kernel of ``csrc/flash_attention.cu``; under ``FakeTensorMode`` (the dry
run) its fake implementation gives the outputs' shapes, and
``torch.utils.flop_counter`` counts it by :func:`visible_pairs`. The kernel is chosen
from dtype and head dims: bf16 at (D, Dv) = (64, 64), (128, 128) or (192,
128) goes to the tensor-core kernel (wgmma, TMA), everything else (D <=
192, Dv <= 128) to the CUDA-core kernel; other head dims raise. All keep the
probabilities in float32 for the PV product, as K3 does (the tensor-core
kernel as bf16 hi + lo halves, two PV products). The kernels mask the
ragged edges themselves, so nothing is padded, and read q, k and v through
their strides: ``(B, S, H, D)`` activations transposed to the
``(B, H, S, D)`` layout cost no copy.

Under autograd (an input that requires grad, grad mode on) the call goes
through :class:`FlashAttention`: the forward is the same kernel, asked also
for each row's float32 log-sum-exp (the statistics the Pallas kernel keeps
as its m and l outputs), and the backward is the operator
``repro_torch::flash_attention_bwd`` (:func:`flash_attention_bwd`): on CUDA
the kernels of ``csrc/flash_attention_bwd.cu`` (bf16 at (D, Dv) in
:data:`WGMMA_HEAD_DIMS` on the tensor cores with ``wgmma`` and TMA, everything
else the forward's CUDA-core kernel takes on the CUDA cores), on the CPU
:func:`flash_attention_backward_plain`, plain PyTorch in float32 (float64
for float64 inputs), which is also the kernels' oracle. The JAX package
has no backward kernel: it differentiates its plain ``blockwise_attention``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

DEFAULT_BLOCK_Q = 512  # the plain version's tiles (the reference's defaults)
DEFAULT_BLOCK_K = 512
# float32 values in one group of the backward's (G, Sq, Sk) score blocks:
# 512 MiB, so at qwen3-1.7b's training shape (B 4, 8 kv heads of G 2, S
# 2048) the backward runs in two groups
BACKWARD_BLOCK_ELEMENTS = 1 << 27
KERNEL_BLOCK_Q = 64  # the CUDA-core kernel's q tile (the tensor-core kernel's is 128)
KERNEL_MAX_HEAD_DIM = 192  # q and k
KERNEL_MAX_V_HEAD_DIM = 128  # v and the output
WGMMA_HEAD_DIMS = ((64, 64), (128, 128), (192, 128))  # bf16 (D, Dv) of the tensor-core kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"need q (B,H,Sq,D), k (B,Hkv,Sk,D) and v (B,Hkv,Sk,Dv), got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, h, _, d = q.shape
    bk, hkv, _, dk = k.shape
    if (bk, dk) != (b, d) or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"n_heads {h} not a multiple of n_kv_heads {hkv}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for float64 inputs (``gradcheck``'s)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _visible(sq: int, sk: int, causal: bool, window: int, device) -> torch.Tensor:
    """(Sq, Sk) bool: the (q, k) pairs the mask keeps."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def flash_attention_plain(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, Dv)
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
    return_lse: bool = False,
):
    """K3's arithmetic in PyTorch: float32 online softmax over
    ``block_q`` x ``block_k`` tiles, fully masked tiles skipped. Never
    holds more than one score tile, so it runs at Sq = Sk = 32768.

    With ``return_lse`` also each row's log-sum-exp of its scaled scores,
    (B, H, Sq) float32 (+inf for a row with no visible key): returns
    ``(out, lse)``. float64 inputs compute in float64."""
    _check(q, k, v)
    b, h, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // hkv
    ct = _compute_dtype(q.dtype)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    block_q = min(block_q, max(16, sq))
    block_k = min(block_k, max(16, sk))
    qf = q.reshape(b, hkv, g, sq, d).to(ct)
    kf, vf = k.to(ct), v.to(ct)
    out = torch.empty((b, hkv, g, sq, dv), dtype=ct, device=q.device)
    lse = torch.empty((b, hkv, g, sq, 1), dtype=ct, device=q.device) if return_lse else None
    for q0 in range(0, sq, block_q):
        q1 = min(sq, q0 + block_q)
        qb = qf[:, :, :, q0:q1]  # (B, Hkv, G, tq, D)
        m = torch.full(qb.shape[:-1] + (1,), float("-inf"), dtype=ct, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qb.shape[:-1] + (dv,), dtype=ct, device=q.device)
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        for k0 in range(0, sk, block_k):
            # tile skip, as the Pallas kernel's (tiles of the padded grid)
            if causal and k0 > q0 + block_q - 1:
                continue
            if window > 0 and k0 + block_k - 1 <= q0 - window:
                continue
            k1 = min(sk, k0 + block_k)
            s = torch.matmul(qb, kf[:, :, None, k0:k1].transpose(-1, -2)) * scale
            kpos = torch.arange(k0, k1, device=q.device)[None, :]
            mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=q.device)
            if causal:
                mask &= kpos <= qpos
            if window > 0:
                mask &= kpos > qpos - window
            s = torch.where(mask, s, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            # rows with no visible key yet keep m = -inf; guard exp(-inf + inf)
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.where(mask, torch.exp(s - m_safe), 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.matmul(p, vf[:, :, None, k0:k1])
            m = m_new
        out[:, :, :, q0:q1] = acc / torch.clamp(l, min=1e-30)
        if return_lse:
            lse[:, :, :, q0:q1] = torch.where(l > 0, m + torch.log(l), float("inf"))
    out = out.reshape(b, h, sq, dv).to(q.dtype)
    return (out, lse.reshape(b, h, sq)) if return_lse else out


def flash_attention_backward_plain(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, Dv)
    o: torch.Tensor,  # (B, H, Sq, Dv): the forward's output
    lse: torch.Tensor,  # (B, H, Sq): the forward's row log-sum-exp
    do: torch.Tensor,  # (B, H, Sq, Dv): the output's gradient
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of K3 in float32 (float64 for float64 inputs), in the
    inputs' dtypes. P = exp(scale q k^T - lse) under the mask, dV = P^T dO,
    dS = P * (dO V^T - rowsum(dO * O)), dQ = scale dS K, dK = scale dS^T Q;
    a kv head's dK and dV sum over its G query heads. Runs over groups of
    (batch, kv head) pairs whose (G, Sq, Sk) score blocks together hold at
    most :data:`BACKWARD_BLOCK_ELEMENTS` values (two such blocks live at a
    time)."""
    _check(q, k, v)
    b, h, sq, d = q.shape
    hkv, sk, d_v = k.shape[1], k.shape[2], v.shape[3]
    g = h // hkv
    ct = _compute_dtype(q.dtype)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    n = b * hkv
    qf = q.reshape(n, g, sq, d)
    of, dof = (t.reshape(n, g, sq, d_v) for t in (o, do))
    kf, vf = k.reshape(n, sk, d), v.reshape(n, sk, d_v)
    lsef = lse.reshape(n, g, sq, 1)
    hidden = ~_visible(sq, sk, causal, window, q.device)
    dq = torch.empty((n, g, sq, d), dtype=ct, device=q.device)
    dk = torch.empty((n, sk, d), dtype=ct, device=q.device)
    dv = torch.empty((n, sk, d_v), dtype=ct, device=q.device)
    step = max(1, BACKWARD_BLOCK_ELEMENTS // max(1, g * sq * sk))
    for i0 in range(0, n, step):
        sl = slice(i0, i0 + step)
        qc, oc, doc = (t[sl].to(ct) for t in (qf, of, dof))
        kc, vc = (t[sl].to(ct)[:, None] for t in (kf, vf))  # (n', 1, Sk, D)
        p = torch.matmul(qc, kc.transpose(-1, -2))  # (n', G, Sq, Sk)
        p.mul_(scale).sub_(lsef[sl].to(ct)).exp_().masked_fill_(hidden, 0.0)
        dv[sl] = torch.matmul(p.transpose(-1, -2), doc).sum(1)
        ds = torch.matmul(doc, vc.transpose(-1, -2))  # dP
        ds.sub_((doc * oc).sum(-1, keepdim=True)).mul_(p)
        del p
        dq[sl] = torch.matmul(ds, kc).mul_(scale)
        dk[sl] = torch.matmul(ds.transpose(-1, -2), qc).mul_(scale).sum(1)
        del ds
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.reshape(b, hkv, sk, d).to(k.dtype),
            dv.reshape(b, hkv, sk, d_v).to(v.dtype))


@functools.cache
def _kernel(entry: str):
    """``flash_attention_fwd`` (takes a dtype code before the stream) or
    ``flash_attention_fwd_wgmma`` (bf16 only)."""
    fn = getattr(_build.load("flash_attention"), entry)
    dtype = [ctypes.c_int] if entry == "flash_attention_fwd" else []
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int] + dtype
                   + [ctypes.c_void_p, ctypes.c_void_p])  # lse (or None), stream
    fn.restype = ctypes.c_int
    return fn


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a dense copy where the TMA cannot read it: it needs a
    16-byte aligned base and batch, head and sequence strides in whole
    16-byte units (a dimension of extent 1 may have any stride). The
    backward's tensor-core kernels load q, k, v and dO by TMA too."""
    nbytes = t.element_size()
    ok = t.numel() == 0 or (t.data_ptr() % 16 == 0 and all(
        n == 1 or (s > 0 and s * nbytes % 16 == 0) for n, s in zip(t.shape[:3], t.stride()[:3])))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _launch(q, k, v, causal: bool, window: int, scale: float, with_lse: bool):
    """``(out, lse)``: the CUDA kernel on ``q``'s card (raising on what it
    does not take); ``lse`` is empty unless ``with_lse``."""
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention needs q, k, v on one CUDA device or on the CPU, "
                         f"got {q.device} {k.device} {v.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16, got {q.dtype}")
    b, h, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    if d > KERNEL_MAX_HEAD_DIM or dv > KERNEL_MAX_V_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head dims D <= {KERNEL_MAX_HEAD_DIM} and "
                         f"Dv <= {KERNEL_MAX_V_HEAD_DIM}, got {d} and {dv}")
    if b * h >= 2**31 or sq > 65535 * KERNEL_BLOCK_Q or sk >= 2**31:
        raise ValueError(f"flash_attention shapes beyond the kernel's grid: "
                         f"q{tuple(q.shape)} k{tuple(k.shape)}")
    wgmma = q.dtype == torch.bfloat16 and (d, dv) in WGMMA_HEAD_DIMS
    # the kernels read rows through strides; each row's D values must be dense
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if wgmma:
        q, k, v = (_tma_ready(t) for t in (q, k, v))
    out, lse = _outputs(q, v, with_lse)
    if out.numel():
        strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv, sq, sk, d, dv,
                *strides, scale, int(bool(causal)), window]
        entry = "flash_attention_fwd_wgmma" if wgmma else "flash_attention_fwd"
        if not wgmma:
            args.append(_DTYPES[q.dtype])
        args.append(lse.data_ptr() if with_lse else None)
        with torch.cuda.device(q.device):  # the launch goes to the current device
            err = _kernel(entry)(*args, torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
        flash_attention.launches += 1
        if wgmma:
            flash_attention.wgmma_launches += 1
        if with_lse:
            flash_attention.lse_launches += 1
    return out, lse


def _outputs(q, v, with_lse: bool):
    """Empty ``(out, lse)`` for a launch on these inputs: out in q's dense
    layout at Dv columns ((B,S,H,D) storage gives (B,S,H,Dv)); lse (B, H,
    Sq) float32, or empty."""
    b, h, sq, d = q.shape
    dv = v.shape[3]
    out = torch.empty_like(q if dv == d else q[..., :dv])
    lse = q.new_empty((b, h, sq) if with_lse else (0,), dtype=torch.float32)
    return out, lse


# K3's forward as an operator of its own, so that a trace under
# FakeTensorMode (the dry run) sees one op with shapes and a FLOP count
# where the launch would pass raw pointers: the CUDA implementation is the
# launch, the CPU one the plain version, and the fake one makes the outputs.
@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cuda")
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                        window: int, scale: float,
                        with_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of K3's forward; ``lse`` is empty unless ``with_lse``."""
    return _launch(q, k, v, causal, window, scale, with_lse)


@flash_attention_fwd.register_kernel("cpu")
def _flash_attention_fwd_cpu(q, k, v, causal, window, scale, with_lse):
    if with_lse:
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale,
                                     return_lse=True)
    out = flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    return out, q.new_empty((0,), dtype=torch.float32)


@flash_attention_fwd.register_fake
def _flash_attention_fwd_fake(q, k, v, causal, window, scale, with_lse):
    if q.stride(-1) != 1:
        q = q.contiguous()
    return _outputs(q, v, with_lse)


def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """The (q, k) pairs the mask keeps (query i and key j both counted from
    0): the work K3 must do for one batch row and head."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1, np.int64)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flash_attention_flops(q_shape, k_shape, v_shape, causal, window, *args, out_shape=None,
                           **kwargs) -> int:
    """2 (D + Dv) a visible (q, k) pair, batch row and head: QK^T and PV,
    the masked pairs not counted (as ``launch.train.attention_pair_flops``)."""
    b, h, sq, d = q_shape
    sk, dv = k_shape[2], v_shape[3]
    return b * h * visible_pairs(sq, sk, causal, window) * 2 * (d + dv)


def _forward(q, k, v, causal: bool, window: int, scale, with_lse: bool):
    """``(out, lse or None)`` through :func:`flash_attention_fwd`: the plain
    version for CPU tensors, else the CUDA kernel (raising on what it does
    not take); fake tensors get their shapes only."""
    kinds = {t.device.type for t in (q, k, v)}
    if kinds != {"cpu"} and kinds != {"cuda"}:
        raise ValueError(f"flash_attention needs q, k, v on one CUDA device or on the CPU, "
                         f"got {q.device} {k.device} {v.device}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    out, lse = flash_attention_fwd(q, k, v, bool(causal), int(window), scale, with_lse)
    return out, (lse if with_lse else None)


@functools.cache
def _bwd_kernel(entry: str):
    """``flash_attention_bwd`` (takes a dtype code before the stream) or
    ``flash_attention_bwd_mma`` (bf16 only)."""
    fn = getattr(_build.load("flash_attention_bwd"), entry)
    dtype = [ctypes.c_int] if entry == "flash_attention_bwd" else []
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 24
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int] + dtype + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _grad_outputs(q, k, v):
    """Empty ``(dq, dk, dv)``: each in its input's dense layout where that
    keeps the last dimension dense ((B, S, H, D) storage gives the same),
    else contiguous."""
    def like(t):
        out = torch.empty_like(t)
        return out if out.stride(-1) == 1 else t.new_empty(t.shape)

    return like(q), like(k), like(v)


def _launch_backward(q, k, v, o, lse, do, causal: bool, window: int, scale: float):
    """``(dq, dk, dv)``: the CUDA kernels on ``q``'s card (raising on what
    they do not take); zero gradients and no launch where Sq or Sk is 0."""
    _check(q, k, v)
    if any(t.device != q.device for t in (k, v, o, lse, do)):
        raise ValueError("flash_attention_bwd needs every input on one CUDA device")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the CUDA kernels take float32 or bfloat16, got {q.dtype}")
    if not (q.dtype == k.dtype == v.dtype == o.dtype == do.dtype):
        raise ValueError(f"dtypes differ: q {q.dtype} k {k.dtype} v {v.dtype} o {o.dtype} "
                         f"dout {do.dtype}")
    b, h, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    if o.shape != (b, h, sq, dv) or do.shape != o.shape or lse.shape != (b, h, sq):
        raise ValueError(f"o{tuple(o.shape)}, dout{tuple(do.shape)}, lse{tuple(lse.shape)} "
                         f"do not match q{tuple(q.shape)} v{tuple(v.shape)}")
    if lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32, got {lse.dtype}")
    if d > KERNEL_MAX_HEAD_DIM or dv > KERNEL_MAX_V_HEAD_DIM:
        raise ValueError(f"the CUDA kernels take head dims D <= {KERNEL_MAX_HEAD_DIM} and "
                         f"Dv <= {KERNEL_MAX_V_HEAD_DIM}, got {d} and {dv}")
    if b * h >= 2**31 or sq > 65535 * KERNEL_BLOCK_Q or sk > 65535 * KERNEL_BLOCK_Q:
        raise ValueError(f"flash_attention_bwd shapes beyond the kernels' grids: "
                         f"q{tuple(q.shape)} k{tuple(k.shape)}")
    dq, dk, dv_ = _grad_outputs(q, k, v)
    if q.numel() == 0 or sk == 0:  # no pair: zero gradients (dk, dv empty where Sk is 0)
        return dq.zero_(), dk.zero_(), dv_.zero_()
    mma = q.dtype == torch.bfloat16 and (d, dv) in WGMMA_HEAD_DIMS
    # the kernels read rows through strides; each row's values must be dense
    q, k, v, o, do = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v, o, do))
    if mma:
        q, k, v, do = (_tma_ready(t) for t in (q, k, v, do))
    lse = lse.contiguous()
    # rowsum(dO * o), scratch; the tensor-core kernels' holds each 64-row
    # tile's lse log2(e) and D side by side, padded to whole tiles
    rows = 2 * 64 * -(-sq // 64) if mma else sq
    delta = q.new_empty((b, h, rows), dtype=torch.float32)
    strides = [s for t in (q, k, v, o, do, dq, dk, dv_) for s in t.stride()[:3]]
    args = [t.data_ptr() for t in (q, k, v, o, do, lse, delta, dq, dk, dv_)]
    args += [b, h, hkv, sq, sk, d, dv, *strides, scale, int(bool(causal)), window]
    entry = "flash_attention_bwd_mma" if mma else "flash_attention_bwd"
    if not mma:
        args.append(_DTYPES[q.dtype])
    with torch.cuda.device(q.device):  # the launches go to the current device
        err = _bwd_kernel(entry)(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {err}")
    flash_attention.bwd_launches += 1
    if mma:
        flash_attention.bwd_mma_launches += 1
    return dq, dk, dv_


# K3's backward as an operator of its own, as the forward is: the CUDA
# implementation is the launch, the CPU one the plain version (float64
# included, for gradcheck), and the fake one makes the outputs, so the dry
# run traces it and counts it by its formula.
@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cuda")
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, causal: bool, window: int,
                        scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of K3 from its inputs, its output ``o``, the row
    log-sum-exp ``lse`` its forward wrote and the output's gradient ``do``."""
    return _launch_backward(q, k, v, o, lse, do, causal, window, scale)


@flash_attention_bwd.register_kernel("cpu")
def _flash_attention_bwd_cpu(q, k, v, o, lse, do, causal, window, scale):
    return flash_attention_backward_plain(q, k, v, o, lse, do, causal=causal, window=window,
                                          scale=scale)


@flash_attention_bwd.register_fake
def _flash_attention_bwd_fake(q, k, v, o, lse, do, causal, window, scale):
    return _grad_outputs(q, k, v)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _flash_attention_bwd_flops(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape, causal,
                               window, *args, out_shape=None, **kwargs) -> int:
    """2 (4 D + 3 Dv) a visible (q, k) pair, batch row and head: the
    two-pass algorithm's products, S = q k^T twice (the dK/dV pass and the
    dQ pass, which recomputes it rather than sum dQ by atomics), dP = dO v^T
    twice, dV = P^T dO, dK = dS^T q and dQ = dS k; the least work is 2 (3 D
    + 2 Dv). The dry run counts this. The bf16 tensor-core kernels run each
    product with P or dS twice (its bf16 hi and lo halves), 2 (6 D + 5 Dv)
    on the tensor cores; the CUDA-core kernels run this count."""
    b, h, sq, d = q_shape
    sk, dv = k_shape[2], v_shape[3]
    return b * h * visible_pairs(sq, sk, causal, window) * 2 * (4 * d + 3 * dv)


class FlashAttention(torch.autograd.Function):
    """K3 under autograd: the forward kernel with ``lse``, the backward the
    operator :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale):
        out, lse = _forward(q, k, v, causal, window, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        scale = float(ctx.scale) if ctx.scale is not None else 1.0 / math.sqrt(q.shape[-1])
        # a named range, so a profile can attribute the backward's kernels
        with torch.profiler.record_function("flash_attention_backward"):
            dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, bool(ctx.causal),
                                             int(ctx.window), scale)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, Dv)
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """(B, H, Sq, Dv) in q's dtype — the plain version (512 x 512 tiles) on
    the CPU; on CUDA the tensor-core kernel (128 x 64 tiles) for bf16 at
    (D, Dv) in :data:`WGMMA_HEAD_DIMS`, the CUDA-core kernel (64 x 64 tiles)
    otherwise. Where an
    input requires grad (and grad mode is on), through :class:`FlashAttention`."""
    _check(q, k, v)
    window = int(window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, bool(causal), window, scale)
    return _forward(q, k, v, causal, window, scale, False)[0]


flash_attention.launches = 0  # kernel launches since the last reset, either kernel
flash_attention.wgmma_launches = 0  # of those, the tensor-core kernel's
flash_attention.lse_launches = 0  # of those, the ones that also wrote lse (training)
flash_attention.bwd_launches = 0  # backward launches (delta, dK/dV and dQ kernels), either variant
flash_attention.bwd_mma_launches = 0  # of those, the tensor-core variant's
