"""The port's layers, GQA attention and qwen3-1.7b model against the JAX
package, on the CPU, with the JAX package's weights carried across by
``params_from_numpy`` and inputs made with numpy from a seed.

Tolerances: in a float32 configuration the two packages differ by the
order of float32 sums only, so 1e-4; in the bf16 configuration by where
bf16 rounds (and K3 keeps the PV probabilities float32 where the
reference's ``blockwise_attention`` rounds them to bf16), so the
``atol=0.1, rtol=0.05`` of ``tests/test_models.py``'s decode check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.models import Model, params_from_numpy
from repro_torch.models import attention as attn
from repro_torch.models import layers

ARCH = "qwen3-1.7b"
TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=0.1, rtol=0.05)}


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x, dtype=None):
    """numpy/jax array -> CPU tensor with the same values (bf16 kept)."""
    x = np.array(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    t = torch.from_numpy(x)
    return t if dtype is None else t.to(dtype)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _models(dtype):
    jcfg = jax_smoke_config(ARCH).with_(dtype=dtype)
    cfg = get_smoke_config(ARCH).with_(dtype=dtype)
    jm = JModel(jcfg)
    jparams, _ = jm.init(jax.random.PRNGKey(0))
    return jm, jparams, Model(cfg), params_from_numpy(_to_numpy(jparams), cfg, "cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rope(dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 9, 4, 16)), dtype)
    scale = jnp.asarray(1 + 0.1 * rng.standard_normal(16), dtype)
    got = layers.rmsnorm(_t(x), _t(scale), 1e-5)
    want = jlayers.rmsnorm(x, scale, 1e-5)
    assert got.dtype == getattr(torch, dtype)
    # float32: one rounding apart; bf16: one bf16 ulp (2**-8 relative)
    tol = dict(atol=1e-6, rtol=1e-5) if dtype == "float32" else dict(atol=1e-2, rtol=8e-3)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    pos = np.arange(9) + 1000
    got = layers.apply_rope(_t(x), torch.from_numpy(pos), 1_000_000.0)
    want = jlayers.apply_rope(x, jnp.asarray(pos), 1_000_000.0)
    # sin/cos of angles ~1e3 differ by float32 ulps between the frameworks
    tol = dict(atol=2e-4, rtol=1e-4) if dtype == "float32" else dict(atol=1.6e-2, rtol=8e-3)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def test_unembed_logits_are_float32_from_bf16():
    rng = np.random.default_rng(1)
    h = jnp.asarray(rng.standard_normal((3, 64)), jnp.bfloat16)
    emb = jnp.asarray(rng.standard_normal((40000, 64)), jnp.bfloat16)  # > one row block
    got = layers.unembed_logits(_t(h), _t(emb))
    want = jlayers.unembed_logits(h, emb)
    assert got.dtype == torch.float32 and got.shape == (3, 40000)
    # exact bf16 products, float32 sums in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)


def test_init_is_seeded_and_truncated():
    cfg = get_smoke_config(ARCH)
    a = Model(cfg).init(torch.Generator().manual_seed(5))
    b = Model(cfg).init(torch.Generator().manual_seed(5))
    c = Model(cfg).init(torch.Generator().manual_seed(6))
    wq = a["blocks"]["g0"]["attn"]["wq"]
    assert torch.equal(wq, b["blocks"]["g0"]["attn"]["wq"])
    assert not torch.equal(wq, c["blocks"]["g0"]["attn"]["wq"])
    assert wq.dtype == torch.bfloat16 and wq.abs().max() <= 2.0 / np.sqrt(cfg.d_model) + 1e-3
    # the JAX package's tree: same paths, shapes and dtypes
    jparams, _ = JModel(jax_smoke_config(ARCH)).init(jax.random.PRNGKey(0))
    jflat = {jax.tree_util.keystr(k): (v.shape, str(v.dtype))
             for k, v in jax.tree_util.tree_leaves_with_path(jparams)}
    tflat = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype).replace("torch.", ""))
             for k, v in jax.tree_util.tree_leaves_with_path(a)}
    assert jflat == tflat


def test_params_from_numpy_checks_the_tree():
    cfg = get_smoke_config(ARCH)
    jparams, _ = JModel(jax_smoke_config(ARCH)).init(jax.random.PRNGKey(0))
    tree = _to_numpy(jparams)
    tree["blocks"]["g0"]["ffn"]["wg"] = tree["blocks"]["g0"]["ffn"]["wg"][:, :, :-1]
    with pytest.raises(ValueError, match="wg"):
        params_from_numpy(tree, cfg, "cpu")
    tree = _to_numpy(jparams)
    del tree["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_numpy(tree, cfg, "cpu")


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_train_and_decode(dtype):
    jcfg = jax_smoke_config(ARCH).with_(dtype=dtype)
    cfg = get_smoke_config(ARCH).with_(dtype=dtype)
    jp, _ = jattn.init_gqa(jax.random.PRNGKey(3), jcfg, 1)
    jp = {k: v[0] for k, v in jp.items()}
    # non-trivial norm scales, so q_norm/k_norm are exercised
    rng = np.random.default_rng(2)
    jp["q_norm"] = jnp.asarray(1 + 0.2 * rng.standard_normal(16), dtype)
    jp["k_norm"] = jnp.asarray(1 + 0.2 * rng.standard_normal(16), dtype)
    p = {k: _t(v) for k, v in jp.items()}
    x = jnp.asarray(rng.standard_normal((2, 20, cfg.d_model)), dtype)
    got = attn.gqa_train(p, _t(x), cfg)
    want = jattn.gqa_train(jp, x, jcfg)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])

    # prefill 18 positions into a 20-slot cache, then decode positions 18, 19
    y, cache = attn.gqa_prefill(p, _t(x[:, :18]), cfg, 20)
    jcache = jattn.gqa_prefill_cache(jp, x[:, :18], jcfg, 20)
    np.testing.assert_allclose(_f32(y), _f32(jattn.gqa_train(jp, x[:, :18], jcfg)), **TOL[dtype])
    np.testing.assert_allclose(_f32(cache["k"]), _f32(jcache["k"]), **TOL[dtype])
    for pos in (18, 19):
        got, cache = attn.gqa_decode(p, _t(x[:, pos:pos + 1]), cache, pos, cfg)
        want, jcache = jattn.gqa_decode(jp, x[:, pos:pos + 1], jcache, jnp.int32(pos), jcfg)
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])
    np.testing.assert_allclose(_f32(cache["v"]), _f32(jcache["v"]), **TOL[dtype])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_prefill_decode_matches_jax(dtype):
    jm, jparams, m, params = _models(dtype)
    cfg = m.cfg
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, s_max=28)
    tl, tc = m.prefill(params, {"tokens": torch.from_numpy(toks).long()}, s_max=28)
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL[dtype])
    assert set(tc) == set(jc) == {"g0"}
    for key in ("k", "v"):
        assert tuple(tc["g0"][key].shape) == jc["g0"][key].shape == (2, 2, 28, 2, 16)
        np.testing.assert_allclose(_f32(tc["g0"][key]), _f32(jc["g0"][key]), **TOL[dtype])
    for i in range(3):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jm.decode(jparams, jc, jnp.asarray(tok), jnp.asarray(24 + i, jnp.int32))
        tl, tc = m.decode(params, tc, torch.from_numpy(tok).long(), 24 + i)
        assert tl.dtype == torch.float32 and tl.shape == (2, 1, cfg.vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL[dtype])
    spec = m.cache_struct(2, 28)["g0"]["k"]
    assert spec.shape == jm.cache_struct(2, 28)["g0"]["k"].shape
    assert not m.init_cache(2, 28, "cpu")["g0"]["v"].any()


@pytest.mark.parametrize("arch", ["yi-34b", "stablelm-12b", "command-r-plus-104b"])
def test_other_dense_gqa_archs_match_jax_f32(arch):
    """The other dense GQA configurations (attention biases, untied
    unembedding, no qk-norm) through the same modules, in float32."""
    cfg = get_smoke_config(arch).with_(dtype="float32")
    jm = JModel(jax_smoke_config(arch).with_(dtype="float32"))
    jparams, _ = jm.init(jax.random.PRNGKey(1))
    m, params = Model(cfg), params_from_numpy(_to_numpy(jparams), cfg, "cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, s_max=22)
    tl, tc = m.prefill(params, {"tokens": torch.from_numpy(toks).long()}, s_max=22)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL["float32"])
    jl, _ = jm.decode(jparams, jc, jnp.asarray(toks[:, :1]), jnp.int32(20))
    tl, _ = m.decode(params, tc, torch.from_numpy(toks[:, :1]).long(), 20)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL["float32"])


def test_decode_matches_teacher_forcing():
    """Decode logits at position t == the parallel pass's logits at t: the
    cache path must reproduce the prefill path (tests/test_models.py)."""
    cfg = get_smoke_config(ARCH)
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (2, 24)))
    want, _ = m.prefill(params, {"tokens": toks}, s_max=24)  # logits after the last token
    cut = 22
    _, caches = m.prefill(params, {"tokens": toks[:, :cut]}, s_max=24)
    for i in range(cut, 24):
        lg, caches = m.decode(params, caches, toks[:, i:i + 1], i)
    np.testing.assert_allclose(lg[:, 0].numpy(), want.numpy(), atol=0.1, rtol=0.05)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "hymba-1.5b",
                                  "xlstm-1.3b", "whisper-tiny", "internvl2-76b"])
def test_unported_archs_raise(arch):
    assert arch in list_archs()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(get_smoke_config(arch))
