"""K3's plain version (what the port runs on CPU tensors) against the JAX
package: the Pallas kernel in interpret mode, its ``attention_ref`` oracle
and the model's ``blockwise_attention``.

Inputs are made with numpy from a seed and rounded to the case's dtype
once, so both packages see the same values. Tolerances are those of
``tests/test_kernels.py``: 2e-5 in float32 (sums in another order) and
2e-2 in bfloat16 (the output is rounded to bf16 once; one bf16 ulp near 1
is 2**-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.models.attention import blockwise_attention
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_attention.ops import _tma_ready

_FLASH_CASES = [
    # (b, h, hkv, sq, sk, d, causal, window, dtype): tests/test_kernels.py's six
    (2, 4, 4, 128, 128, 64, True, 0, "float32"),
    (1, 8, 2, 257, 257, 64, True, 0, "float32"),  # GQA + ragged edge
    (2, 4, 2, 200, 200, 128, True, 64, "float32"),  # sliding window
    (1, 4, 4, 96, 160, 64, False, 0, "bfloat16"),  # bidirectional, sk != sq
    (1, 2, 1, 512, 512, 64, True, 0, "bfloat16"),  # MQA
    (1, 4, 4, 64, 64, 128, True, 32, "bfloat16"),  # window + bf16
]


def _inputs(case, seed):
    b, h, hkv, sq, sk, d, _, _, dt = case
    rng = np.random.default_rng(seed)
    arrays = [jnp.asarray(rng.standard_normal(shape), dtype=dt)
              for shape in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    tensors = [torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dt)) for a in arrays]
    return arrays, tensors


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("case", _FLASH_CASES, ids=[str(c) for c in _FLASH_CASES])
def test_plain_matches_pallas_interpret_and_ref(case):
    *_, causal, window, dt = case
    (jq, jk, jv), (q, k, v) = _inputs(case, seed=sum(case[:6]))
    got = flash_attention_plain(q, k, v, causal=causal, window=window, block_q=64, block_k=64)
    assert got.dtype == q.dtype and got.shape == q.shape
    pallas = jax_flash_attention(jq, jk, jv, causal=causal, window=window,
                                 block_q=64, block_k=64, interpret=True)
    ref = attention_ref(jq, jk, jv, causal=causal, window=window)
    tol = 2e-2 if dt == "bfloat16" else 2e-5
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(got), _f32(ref), atol=tol, rtol=tol)
    # the wrapper's default tiles (512) give the same answer
    np.testing.assert_allclose(_f32(flash_attention(q, k, v, causal=causal, window=window)),
                               _f32(ref), atol=tol, rtol=tol)


def test_block_shape_independence():
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 300, 64)).astype(np.float32))
               for _ in range(3))
    outs = [flash_attention_plain(q, k, v, block_q=bq, block_k=bk).numpy()
            for bq, bk in [(64, 64), (128, 32), (32, 128), (512, 512)]]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], atol=1e-5, rtol=1e-5)


def test_rows_without_a_visible_key_are_exactly_zero():
    # bidirectional with a window, sk < sq: row q sees keys in (q - 32, 64),
    # so rows 95.. see none (the attention_ref oracle would give NaN there)
    case = (1, 4, 2, 200, 64, 64, False, 32, "float32")
    (jq, jk, jv), (q, k, v) = _inputs(case, seed=3)
    got = flash_attention_plain(q, k, v, causal=False, window=32, block_q=64, block_k=32).numpy()
    assert np.all(got[:, :, 95:] == 0.0)
    assert np.all(np.abs(got[:, :, :95]).sum(-1) > 0)
    pallas = jax_flash_attention(jq, jk, jv, causal=False, window=32, block_q=64, block_k=32,
                                 interpret=True)
    np.testing.assert_allclose(got, _f32(pallas), atol=2e-5, rtol=2e-5)
    # no key at all: every row 0
    empty = flash_attention(q, k[:, :, :0], v[:, :, :0])
    assert empty.shape == q.shape and not empty.any()


@pytest.mark.parametrize("s,window", [(70, 0), (64, 24), (70, 24)])
def test_matches_blockwise_attention_f32(s, window):
    """The model's XLA attention, (B,S,KV,G,D) layout, in float32: K3 keeps
    the probabilities float32 as blockwise_attention does in float32.

    With a window and S not a multiple of q_block, the reference's last q
    block reads the wrong keys (its ``dynamic_slice`` clamps the start of
    the key span at the padded end), so there K3 is held against
    ``attention_ref`` and the reference's faulty rows are pinned."""
    rng = np.random.default_rng(11 + window)
    b, kv, g, d, q_block = 2, 2, 3, 16, 16
    q = rng.standard_normal((b, s, kv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    blockwise = np.asarray(blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               causal=True, window=window, q_block=q_block))
    tq = torch.from_numpy(q).reshape(b, s, kv * g, d).transpose(1, 2)
    tk, tv = (torch.from_numpy(x).transpose(1, 2) for x in (k, v))
    got = flash_attention(tq, tk, tv, causal=True, window=window).transpose(1, 2)
    got = got.reshape(b, s, kv, g, d).numpy()
    ragged = window > 0 and s % q_block
    if not ragged:
        np.testing.assert_allclose(got, blockwise, atol=2e-5, rtol=2e-5)
        return
    ref = attention_ref(*(jnp.asarray(x.numpy()) for x in (tq, tk, tv)), causal=True,
                        window=window)
    ref = np.asarray(ref).transpose(0, 2, 1, 3).reshape(b, s, kv, g, d)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
    tail = s - s % q_block
    np.testing.assert_allclose(got[:, :tail], blockwise[:, :tail], atol=2e-5, rtol=2e-5)
    assert not np.allclose(got[:, tail:], blockwise[:, tail:], atol=1e-3)


def _rounding_limit_use(out, ref32):
    """max |out - ref32| / (2**-8 |ref32| + 2e-5): at most 1 where the bf16
    ``out`` is the float32 ``ref32`` rounded once (the limit chip_smoke.py
    and test_torch_cuda.py hold the CUDA kernel to)."""
    return float(((out.float() - ref32).abs() / (2.0 ** -8 * ref32.abs() + 2e-5)).max())


def test_bf16_one_rounding_limit_rejects_wrong_attention():
    rng = np.random.default_rng(5)
    s, d = 512, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16().float()
               for shape in ((1, 2, s, d), (1, 1, s, d), (1, 1, s, d)))
    ref32 = flash_attention_plain(q, k, v)
    assert _rounding_limit_use(flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16()),
                               ref32) <= 1.0
    i, j = torch.arange(s)[:, None], torch.arange(s)[None, :]

    def masked(keep):
        scores = (q @ k.repeat_interleave(2, 1).transpose(-1, -2)) / d ** 0.5
        p = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
        return (p @ v.repeat_interleave(2, 1)).bfloat16()

    assert _rounding_limit_use(masked(j <= i), ref32) <= 1.0
    wrong = {"causal off by one": masked(j <= i + 1),
             "one key tile dropped": masked((j <= i) & ~((j >= 64) & (j < 128) & (i >= 256))),
             "scale off by 0.1 %": flash_attention_plain(q, k, v, scale=0.999 / d ** 0.5)
             .bfloat16()}
    for name, out in wrong.items():
        assert _rounding_limit_use(out, ref32) > 10, name


def _tensor_core_arithmetic(q, k, v, *, split, q_tile=128, k_tile=64):
    """The tensor-core kernel's arithmetic in plain PyTorch, causal: float32
    scores and online softmax over q_tile x k_tile blocks, P V as products of
    bf16 values summed in float32 (as wgmma does) — P split into hi = bf16(P)
    and lo = bf16(P - hi), two products (``split``), or P rounded to bf16
    once, the textbook design."""
    b, h, s, d = q.shape
    kf, vf = (t.repeat_interleave(h // k.shape[1], dim=1) for t in (k, v))
    scale = 1.0 / d ** 0.5
    out = torch.empty_like(q)
    for q0 in range(0, s, q_tile):
        qb = q[:, :, q0:q0 + q_tile]
        m = torch.full(qb.shape[:-1] + (1,), float("-inf"))
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        qpos = torch.arange(q0, q0 + qb.shape[2])[:, None]
        for k0 in range(0, min(s, q0 + q_tile), k_tile):
            kpos = torch.arange(k0, min(s, k0 + k_tile))[None, :]
            sc = (qb @ kf[:, :, k0:k0 + k_tile].transpose(-1, -2)) * scale
            sc = sc.masked_fill(kpos > qpos, float("-inf"))
            m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            p = torch.exp(sc - m_new)
            corr = torch.exp(m - m_new)
            hi = p.bfloat16().float()
            pv = hi @ vf[:, :, k0:k0 + k_tile]
            if split:
                pv = pv + (p - hi).bfloat16().float() @ vf[:, :, k0:k0 + k_tile]
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + pv
            m = m_new
        out[:, :, q0:q0 + q_tile] = acc / l
    return out.bfloat16()


@pytest.mark.parametrize("s,d", [(512, 64), (2048, 128)])
def test_split_bf16_probabilities_keep_one_rounding(s, d):
    """Why the tensor-core kernel runs two PV products: with P as bf16 hi + lo
    halves its output stays within one bf16 rounding of the float32 answer,
    the limit chip_smoke.py holds the kernel to; P rounded to bf16 once
    breaks that limit more than 10x."""
    rng = np.random.default_rng(s + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16().float()
               for shape in ((1, 4, s, d), (1, 2, s, d), (1, 2, s, d)))
    ref32 = flash_attention_plain(q, k, v)
    assert _rounding_limit_use(_tensor_core_arithmetic(q, k, v, split=True), ref32) <= 1.0
    assert _rounding_limit_use(_tensor_core_arithmetic(q, k, v, split=False), ref32) > 10


def test_tma_ready_copies_only_what_the_tma_cannot_read():
    x = torch.zeros(2, 64, 8, 128, dtype=torch.bfloat16)
    bshd = x.transpose(1, 2)  # the model's (B, S, H, D) storage seen as (B, H, S, D)
    assert _tma_ready(bshd) is bshd
    one = torch.zeros(4 * 64 * 64, dtype=torch.bfloat16).as_strided((1, 4, 64, 64),
                                                                   (5, 64 * 64, 64, 1))
    assert _tma_ready(one) is one  # an extent-1 dimension's stride is never used
    flat = x.view(-1)
    bad = {"base 2 bytes off": flat[1:1 + 4 * 64 * 64].view(1, 4, 64, 64),
           "row stride 66": flat[:4 * 64 * 66].view(1, 4, 64, 66)[..., :64]}
    for name, t in bad.items():
        out = _tma_ready(t)
        assert out is not t and out.is_contiguous() and out.data_ptr() % 16 == 0, name
        assert torch.equal(out, t), name


def test_wrapper_checks_and_no_fallback():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="shape mismatch"):
        flash_attention(q, torch.zeros(1, 2, 8, 8), torch.zeros(1, 2, 8, 8))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention(q, torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 8, 16, dtype=torch.bfloat16))
    # a tensor that is neither on the CPU nor on a CUDA card is refused, not
    # quietly run through the plain version
    meta = torch.zeros(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        flash_attention(meta, meta, meta)
    before = flash_attention.launches
    flash_attention(q, torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 8, 16))
    assert flash_attention.launches == before  # the plain version is no launch


# MLA's shape in miniature: qk head dim D (nope + rope) apart from v's Dv,
# G = 1; and deepseek-v3's widths (192, 128) at a short sequence
_DV_CASES = [
    # (b, h, sq, d, dv, causal, dtype)
    (2, 3, 40, 24, 16, True, "float32"),
    (1, 4, 70, 48, 32, True, "float32"),
    (1, 2, 64, 192, 128, True, "float32"),
    (1, 2, 33, 24, 16, False, "float32"),
    (1, 4, 64, 192, 128, True, "bfloat16"),
]


@pytest.mark.parametrize("case", _DV_CASES, ids=[str(c) for c in _DV_CASES])
def test_plain_with_v_head_dim_apart_matches_blockwise_attention(case):
    """v's head dim apart from q's and k's (MLA): the plain version (what
    K3 runs on the CPU, and the CUDA kernels' yardstick) against the
    model's ``blockwise_attention``, scale 1/sqrt(D), the output Dv wide.
    The Pallas kernel and ``attention_ref`` take Dv == D only, so the
    reference here is ``blockwise_attention``. float32: 2e-5; bf16: one
    rounding apart (2e-2), the reference rounding P to bf16 first."""
    b, h, s, d, dv, causal, dt = case
    rng = np.random.default_rng(s + d + dv)
    dtype = getattr(torch, dt)
    q, k = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    q, k, v = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    ref = blockwise_attention(*(jnp.asarray(x.float().numpy(), dtype=dt) for x in
                                (q[:, :, :, None], k, v)), causal=causal, q_block=16)
    got = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=causal)
    assert got.shape == (b, h, s, dv) and got.dtype == dtype
    tol = 2e-2 if dt == "bfloat16" else 2e-5
    np.testing.assert_allclose(_f32(got.transpose(1, 2)), _f32(ref)[:, :, :, 0], atol=tol,
                               rtol=tol)
    # the lse the training forward keeps, against a float64 logsumexp
    _, lse = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=causal, return_lse=True, block_q=16, block_k=16)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) / d ** 0.5
    if causal:
        sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1), float("-inf"))
    np.testing.assert_allclose(lse.double().numpy(), torch.logsumexp(sc, -1).numpy(), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_backward_with_v_head_dim_apart_gradcheck_float64(causal):
    """K3 under autograd with Dv != D (the plain forward's lse, the plain
    backward's dV at Dv) against float64 finite differences."""
    from repro_torch.kernels.flash_attention import FlashAttention

    rng = np.random.default_rng(17)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).requires_grad_(True)
               for shape in ((1, 2, 7, 6), (1, 2, 7, 6), (1, 2, 7, 4)))
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: FlashAttention.apply(q_, k_, v_, causal, 0, None), (q, k, v))


def test_wrapper_refuses_v_that_differs_beyond_its_head_dim():
    q = torch.zeros(1, 2, 8, 24)
    with pytest.raises(ValueError, match="shape mismatch"):
        flash_attention(q, torch.zeros(1, 2, 8, 24), torch.zeros(1, 2, 9, 16))
    assert flash_attention(q, torch.zeros(1, 2, 8, 24), torch.zeros(1, 2, 8, 16)).shape == \
        (1, 2, 8, 16)
