"""K3's backward as the operator ``repro_torch::flash_attention_bwd``.

On the CPU the operator runs its CPU implementation,
``flash_attention_backward_plain`` (the CUDA kernels of
``csrc/flash_attention_bwd.cu`` run on the card: ``tests/test_torch_cuda.py``).
Held here: its schema and fake implementation (``torch.library.opcheck``),
that autograd through :class:`FlashAttention` reaches it, that the FLOP
counters count it by its formula, and its gradients against ``jax.grad`` of
the reference's ``attention_ref``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_plain,
    visible_pairs,
)

# (b, h, hkv, sq, sk, d, dv, causal, window)
CASES = [
    (1, 2, 2, 24, 24, 8, 8, True, 0),  # causal
    (2, 4, 2, 33, 33, 16, 16, True, 9),  # window, G 2
    (1, 4, 1, 20, 20, 8, 8, False, 0),  # non-causal, G 4
    (1, 2, 1, 17, 29, 8, 8, True, 0),  # Sq < Sk, causal
    (2, 2, 2, 29, 12, 8, 8, False, 0),  # Sq > Sk, non-causal
    (1, 6, 2, 16, 16, 12, 8, True, 5),  # Dv != D (MLA's kind), window, G 3
    (1, 2, 1, 10, 0, 8, 8, True, 0),  # Sk = 0
]


def _inputs(case, dtype, seed=0):
    """q, k, v, the forward's output and lse (the plain version's), dout."""
    b, h, hkv, sq, sk, d, dv, causal, window = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape)).to(dtype) for shape in
                   ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv), (b, h, sq, dv)))
    o, lse = flash_attention_plain(q, k, v, causal=causal, window=window, return_lse=True)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_backward_op_opcheck(case, dtype):
    """``torch.library.opcheck``'s schema, fake-tensor, autograd-registration
    and AOT dispatch checks on the CPU implementation. None is left out: the
    operator has no autograd formula of its own (``FlashAttention`` calls
    it inside its backward), and no input here requires grad."""
    q, k, v, o, lse, do = _inputs(case, dtype)
    causal, window = case[7], case[8]
    torch.library.opcheck(flash_attention_bwd,
                          (q, k, v, o, lse, do, causal, window, 1.0 / case[5] ** 0.5))


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_backward_op_shapes_and_zero_rows(case):
    """The gradients' shapes and dtypes; Sk = 0 gives zero dq and empty dk,
    dv; a row that sees no key (Sq > Sk non-causal has none; causal Sq < Sk
    none) has a zero dq row and no NaN anywhere."""
    b, h, hkv, sq, sk, d, dv, causal, window = case
    q, k, v, o, lse, do = _inputs(case, torch.float32)
    dq, dk, dv_ = flash_attention_bwd(q, k, v, o, lse, do, causal, window, 1.0 / d ** 0.5)
    assert (dq.shape, dk.shape, dv_.shape) == ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv))
    assert all(t.dtype == torch.float32 and torch.isfinite(t).all() for t in (dq, dk, dv_))
    blind = torch.isinf(lse)  # rows with no visible key
    assert not dq[blind].any()
    if sk == 0:
        assert bool(blind.all()) and dk.numel() == dv_.numel() == 0


class _Ops(TorchDispatchMode):
    """Records the name of every op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", CASES[:6], ids=[str(c) for c in CASES[:6]])
def test_autograd_reaches_the_backward_op(case):
    """``FlashAttention``'s backward is one call of the operator (seen by a
    dispatch mode around ``torch.autograd.grad``), and its gradients are the
    operator's own on the saved output and lse, bit for bit."""
    causal, window = case[7], case[8]
    q, k, v, _, _, do = _inputs(case, torch.float32, seed=1)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, window=window)
    with _Ops() as mode:
        got = torch.autograd.grad(out, leaves, do)
    assert mode.names.count("repro_torch.flash_attention_bwd") == 1, mode.names
    assert "aten.bmm" not in mode.names and "aten.mm" not in mode.names  # none outside the op
    o, lse = ops._forward(q, k, v, causal, window, None, True)
    want = flash_attention_bwd(q, k, v, o, lse, do, causal, window, 1.0 / case[5] ** 0.5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_flop_counter_counts_the_formula(case):
    """``FlopCounterMode`` counts the operator at 2 (4 D + 3 Dv) a visible
    pair, batch row and head, and a forward and backward under autograd at
    the forward's 2 (D + Dv) plus that."""
    b, h, hkv, sq, sk, d, dv, causal, window = case
    q, k, v, o, lse, do = _inputs(case, torch.float32)
    pairs = b * h * visible_pairs(sq, sk, causal, window)
    with FlopCounterMode(display=False) as fc:
        flash_attention_bwd(q, k, v, o, lse, do, causal, window, 1.0 / d ** 0.5)
    assert fc.get_total_flops() == pairs * 2 * (4 * d + 3 * dv)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    with FlopCounterMode(display=False) as fc:
        out = flash_attention(*leaves, causal=causal, window=window)
        torch.autograd.grad(out, leaves, do)
    assert fc.get_total_flops() == pairs * (2 * (d + dv) + 2 * (4 * d + 3 * dv))


@pytest.mark.parametrize("case", CASES[:6], ids=[str(c) for c in CASES[:6]])
def test_backward_op_equals_jax_grad(case):
    """The operator's gradients against ``jax.grad`` of the reference's
    ``attention_ref`` (at Dv != D, which it does not take, its einsums
    spelt out), float32, to 1e-4 of each gradient's largest magnitude."""
    b, h, hkv, sq, sk, d, dv, causal, window = case
    q, k, v, o, lse, do = _inputs(case, torch.float32, seed=2)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal, window, 1.0 / d ** 0.5)
    g = h // hkv

    def loss(q_, k_, v_):
        if dv == d:  # the reference's oracle
            return jnp.sum(attention_ref(q_, k_, v_, causal=causal, window=window) * do.numpy())
        # attention_ref reshapes its output to D: the same einsums at Dv
        s = jnp.einsum("bkgqd,bksd->bkgqs", q_.reshape(b, hkv, g, sq, d), k_) / np.sqrt(d)
        qpos, kpos = np.arange(sq)[:, None], np.arange(sk)[None, :]
        mask = np.ones((sq, sk), bool)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        p = jax.nn.softmax(jnp.where(mask, s, -jnp.inf), axis=-1)
        out = jnp.einsum("bkgqs,bksd->bkgqd", p, v_).reshape(b, h, sq, dv)
        return jnp.sum(out * do.numpy())

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for a, w in zip(got, want):
        w = np.asarray(w)
        assert a.shape == w.shape
        assert float(np.abs(a.numpy() - w).max()) <= 1e-4 * max(float(np.abs(w).max()), 1e-30)


def test_grad_outputs_keep_the_input_layout():
    """The gradients' layout, the same under fake tensors (the dry run) and
    on the card: (B, S, H, D) storage read as (B, H, S, D) gives its
    gradient in that storage; a kv head sliced from a fused projection a
    dense tensor of its own order, its last dimension dense; a view whose
    last dimension is strided a contiguous one."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.flash_attention.ops import _grad_outputs

    q = torch.empty(2, 9, 4, 16).transpose(1, 2)  # (B, H, S, D) over (B, S, H, D)
    kv = torch.empty(2, 9, 2, 2, 16)  # a fused kv projection: k = kv[..., 0, :]
    k = kv[:, :, :, 0].transpose(1, 2)
    v = torch.empty(2, 2, 16, 9).transpose(2, 3)  # last dimension strided
    dq, dk, dv = _grad_outputs(q, k, v)
    assert dq.stride() == q.stride() and dv.is_contiguous()
    assert dk.stride(-1) == 1 and dk.untyped_storage().nbytes() == dk.numel() * 4
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
        fdq, fdk, fdv = _grad_outputs(fq, fk, fv)
    assert (fdq.stride(), fdk.stride(), fdv.stride()) == (dq.stride(), dk.stride(), dv.stride())


def _backward_limit_use(grad, ref32):
    """max |grad - ref32| / (2**-8 |ref32| + 2**-10 rms(ref32)): at most 1
    where the bf16 ``grad`` is the float32 ``ref32`` rounded once (the
    limit chip_smoke.py holds the backward kernels to)."""
    rms = ref32.square().mean().sqrt()
    return float(((grad.float() - ref32).abs() / (2.0 ** -8 * ref32.abs() + 2.0 ** -10 * rms)).max())


@pytest.mark.parametrize("case", [(1, 4, 2, 1024, 1024, 64, 64, True, 0),
                                  (1, 2, 1, 1024, 1024, 64, 64, True, 384),
                                  (2, 2, 2, 1024, 700, 64, 32, False, 0)],
                         ids=["causal", "window", "cross"])
def test_bf16_backward_limit_rejects_a_skipped_far_key_tile(case):
    """The operator in bf16 (its CPU implementation: float32 sums, each
    gradient rounded once) within the limit of its float32 answer on the
    same bf16-exact inputs; dq less key tile 0's share in the later half of
    the rows that see it (a dQ kernel that skipped that far tile) beyond
    it."""
    b, h, hkv, sq, sk, d, dv, causal, window = case
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()
                   for shape in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv), (b, h, sq, dv)))
    o, lse = flash_attention_plain(q, k, v, causal=causal, window=window, return_lse=True)
    o = o.bfloat16()
    scale = 1.0 / d ** 0.5
    got = flash_attention_bwd(q, k, v, o, lse, do, causal, window, scale)
    ref32 = flash_attention_bwd(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                                causal, window, scale)
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert max(_backward_limit_use(g, r) for g, r in zip(got, ref32)) <= 1.0
    # key tile 0's scale dS K in the later half of the rows that see it
    kt, vt = (t[:, :, :64].float().repeat_interleave(h // hkv, 1) for t in (k, v))
    seen = ops._visible(sq, sk, causal, window, q.device)[:, :64]
    rows = seen.any(1).nonzero()
    seen[: (int(rows[-1]) + 1) // 2] = False
    p = (q.float() @ kt.transpose(-1, -2) * scale - lse[..., None]).exp() * seen
    ds = p * (do.float() @ vt.transpose(-1, -2) - (do.float() * o.float()).sum(-1, keepdim=True))
    skipped = (got[0].float() - ds @ kt * scale).bfloat16()
    assert _backward_limit_use(skipped, ref32[0]) > 1.0
