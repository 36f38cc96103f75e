"""The port's training path against the JAX package, on the CPU.

Inputs are made with numpy from seeds, and the JAX package's weights and
train state are carried across (``params_from_numpy``,
``train_state_from_numpy``). The configuration is qwen3-1.7b's smoke
config, made float32 with ``with_`` where the comparison is of algorithms.
Tolerances, with their reasons:

* float32 sums taken in another order (XLA's CPU backend against
  PyTorch's): 1e-5 relative on losses and logits, 1e-4 on gradients;
* bf16 models: where the two frameworks round to bf16 (and K3 keeps its
  probabilities float32 where ``blockwise_attention`` rounds them to bf16),
  the ``atol=0.1, rtol=0.05`` of ``tests/test_models.py``'s decode check on
  values, 2e-2 of the largest magnitude on gradients;
* optimizer trajectories: AdamW's first step moves every element by about
  lr times the sign of its gradient, so an element whose gradient is within
  float32 rounding of 0 may step either way: at most 2 lr apart.

The resume checks are bitwise: the port against itself.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import serializer as jser
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import cmi as jcmi
from repro.data import TokenPipeline as JaxTokenPipeline
from repro.kernels.flash_attention import attention_ref
from repro.models import Model as JModel
from repro.models import layers as jlayers
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import init_opt_state as jax_init_opt_state
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.utils import flatten_with_paths as jax_flatten
from repro_torch.checkpoint import SaveOptions, load_manifest
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.core import JobStore
from repro_torch.core import cmi as tcmi
from repro_torch.data import TokenPipeline
from repro_torch.distributed import make_init_fn, make_train_step, state_specs
from repro_torch.distributed import train_state_from_numpy
from repro_torch.distributed.steps import batch_to_device
from repro_torch.kernels.flash_attention import FlashAttention, flash_attention
from repro_torch.launch import train as launch_train
from repro_torch.models import Model, TensorSpec, input_specs, params_from_numpy
from repro_torch.models import layers
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state, warmup_cosine
from repro_torch.utils import flatten_with_paths

ARCH = "qwen3-1.7b"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    """numpy/jax array -> CPU tensor with the same bytes (bf16 kept)."""
    x = np.array(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _bytes(x) -> tuple:
    """(dtype name, shape, raw bytes) of a numpy array or tensor."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return name, tuple(x.shape), x.numpy().tobytes()
    x = np.asarray(x)
    return x.dtype.name, tuple(x.shape), np.ascontiguousarray(x).tobytes()


def _grad_close(got, want, rel):
    got, want = _f32(got), _f32(want)
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-12)


def _batch(cfg, seq_len, batch, seed, step, ignore=0):
    """The reference pipeline's batch, with the first ``ignore`` labels of
    row 0 set to -1 (ignored)."""
    b, _ = JaxTokenPipeline(cfg, seq_len, batch, seed=seed).batch_at(
        {"data_step": step, "seed": seed})
    b = {k: v.copy() for k, v in b.items()}  # tokens and labels share one array
    b["labels"][0, :ignore] = -1
    return b


# ---------------------------------------------------------------------------
# data, schedule, optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (41, 1000)])
def test_token_pipeline_batches_bitwise_reference(seed, step):
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    want, wnext = JaxTokenPipeline(jcfg, 33, 5, seed=seed).batch_at(
        {"data_step": step, "seed": seed})
    got, gnext = TokenPipeline(cfg, 33, 5, seed=seed).batch_at({"data_step": step, "seed": seed})
    assert gnext == wnext == {"data_step": step + 1, "seed": seed}
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in want:
        assert _bytes(got[k]) == _bytes(want[k]), k


def test_token_pipeline_refuses_modality_stubs():
    # both modality stubs are ported now, and a batch carries each config's
    # own (tests/test_torch_encdec.py and test_torch_vision.py hold them
    # bitwise against the reference's); a text-only config carries neither
    vis = TokenPipeline(get_smoke_config("internvl2-76b"), 16, 2).batch_at(
        {"data_step": 0, "seed": 0})[0]
    assert sorted(vis) == ["labels", "tokens", "vis_embeds"]
    assert "enc_frames" in TokenPipeline(get_smoke_config("whisper-tiny"), 16, 2).batch_at(
        {"data_step": 0, "seed": 0})[0]
    assert sorted(TokenPipeline(get_smoke_config(ARCH), 16, 2).batch_at(
        {"data_step": 0, "seed": 0})[0]) == ["labels", "tokens"]


@pytest.mark.parametrize("warmup,total", [(5, 30), (1, 4), (0, 10), (100, 10_000)])
def test_warmup_cosine_equals_reference(warmup, total):
    """Every step 0..total (and past it): float32 arithmetic in the same
    order; the cosine may differ by one float32 rounding between the
    frameworks, so within 2 ulps (rtol 2.4e-7)."""
    for step in list(range(0, min(total, 400) + 1)) + [total + 3]:
        want = float(jax_warmup_cosine(jnp.int32(step), peak_lr=3e-3, warmup=warmup, total=total))
        got = warmup_cosine(torch.tensor(step, dtype=torch.int32), peak_lr=3e-3, warmup=warmup,
                            total=total)
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == pytest.approx(want, rel=2.4e-7, abs=0.0), step
    assert float(warmup_cosine(7, peak_lr=1.0, warmup=0, total=7)) == pytest.approx(0.1)


def _random_tree(rng, dtype):
    return {"a": rng.standard_normal((17, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal((3, 4, 6)).astype(np.float32),
                  "d": rng.standard_normal((9,)).astype(np.float32)}}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_update_equals_reference(moment_dtype, param_dtype):
    """Three updates from random params and gradients (one large enough to
    clip): params, moments, master, count and the gradient norm against the
    reference's. float32 to 1e-6 relative (the global norm is summed in
    another order, and a moment's two terms can cancel: so also 1e-6 of the
    leaf's largest magnitude); bf16 leaves to one bf16 rounding."""
    rng = np.random.default_rng(0)
    jcfg = JaxAdamWConfig(moment_dtype=moment_dtype)
    cfg = AdamWConfig(moment_dtype=moment_dtype)
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x, param_dtype),
                                     _random_tree(rng, param_dtype))
    jopt = jax_init_opt_state(jparams, jcfg)
    params = jax.tree_util.tree_map(_t, _np(jparams))
    opt = init_opt_state(params, cfg)
    for i, scale in enumerate((0.01, 50.0, 0.3)):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape) * scale, param_dtype), jparams)
        lr = jnp.float32(1e-3 * (i + 1))
        jparams, jopt, jm = jax_adamw_update(grads, jopt, jparams, lr, jcfg)
        m = adamw_update(jax.tree_util.tree_map(_t, _np(grads)), opt, params,
                         torch.tensor(float(lr)), cfg)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
    assert int(opt["count"]) == int(jopt["count"]) == 3 and opt["count"].dtype == torch.int32
    for name, got, want in (("params", params, jparams), ("mu", opt["mu"], jopt["mu"]),
                            ("nu", opt["nu"], jopt["nu"]), ("master", opt["master"], jopt["master"])):
        gf, _ = flatten_with_paths(got)
        wf, _ = jax_flatten(want)
        assert list(gf) == list(wf), name
        for k in wf:
            assert str(gf[k].dtype).removeprefix("torch.") == np.asarray(wf[k]).dtype.name
            tol = 2.0 ** -8 if gf[k].dtype == torch.bfloat16 else 1e-6
            np.testing.assert_allclose(_f32(gf[k]), _f32(wf[k]), rtol=tol,
                                       atol=tol * np.abs(_f32(wf[k])).max(), err_msg=f"{name}/{k}")


# ---------------------------------------------------------------------------
# the loss and K3's gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,chunk,ignore", [(70, 16, 5), (64, 64, 0), (9, 64, 3)])
def test_softmax_xent_chunked_value_and_grad(s, chunk, ignore):
    """S not a multiple of the chunk (padded with ignored labels), -1
    labels, a chunk longer than S: value and gradients in h and the
    unembedding against ``jax.value_and_grad`` of the reference."""
    rng = np.random.default_rng(s + chunk)
    h = rng.standard_normal((3, s, 24)).astype(np.float32)
    emb = (rng.standard_normal((50, 24)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 50, (3, s)).astype(np.int32)
    labels[0, :ignore] = -1
    labels[2, -1] = -1
    fn = lambda h_, e_: jlayers.softmax_xent_chunked(h_, e_, jnp.asarray(labels), chunk)  # noqa: E731
    want, (wgh, wge) = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(emb))
    th, te = (torch.from_numpy(x).requires_grad_(True) for x in (h, emb))
    got = layers.softmax_xent_chunked(th, te, torch.from_numpy(labels), chunk)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    gh, ge = torch.autograd.grad(got, (th, te))
    _grad_close(gh, wgh, 1e-4)
    _grad_close(ge, wge, 1e-4)


_GRAD_CASES = [
    # (b, h, hkv, s, d, causal, window): GQA, S not a multiple of any tile
    (2, 4, 2, 70, 16, True, 0),
    (1, 6, 2, 45, 8, True, 12),
    (2, 2, 1, 33, 16, False, 0),
    (1, 4, 4, 129, 32, True, 40),
]


@pytest.mark.parametrize("case", _GRAD_CASES, ids=[str(c) for c in _GRAD_CASES])
def test_flash_attention_gradient_equals_jax(case):
    """dq, dk, dv of K3 under autograd (its plain forward with lse, the
    plain backward) against ``jax.grad`` of the reference's
    ``attention_ref``, float32, to 1e-4 of each gradient's magnitude."""
    b, h, hkv, s, d, causal, window = case
    rng = np.random.default_rng(s)
    q, k, v, dout = (rng.standard_normal(shape).astype(np.float32) for shape in
                     ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, h, s, d)))

    def loss(q_, k_, v_):
        return jnp.sum(attention_ref(q_, k_, v_, causal=causal, window=window) * dout)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, window=window)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        _grad_close(g, w, 1e-4)
    # no grad needed: the forward alone, the same output
    with torch.no_grad():
        assert torch.equal(flash_attention(*leaves, causal=causal, window=window), out)


def test_flash_attention_backward_in_groups_equals_one_group(monkeypatch):
    """The plain backward runs (batch, kv head) pairs in groups sized by
    ``BACKWARD_BLOCK_ELEMENTS``: one pair a group gives the gradients of
    all pairs in one group, to float32 rounding (1e-6)."""
    from repro_torch.kernels.flash_attention import flash_attention_backward_plain
    from repro_torch.kernels.flash_attention import ops

    rng = np.random.default_rng(11)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                     for shape in ((3, 4, 37, 16), (3, 2, 37, 16), (3, 2, 37, 16), (3, 4, 37, 16)))
    out, lse = ops.flash_attention_plain(q, k, v, window=9, return_lse=True)
    whole = flash_attention_backward_plain(q, k, v, out, lse, dout, window=9)
    monkeypatch.setattr(ops, "BACKWARD_BLOCK_ELEMENTS", 1)
    pairs = flash_attention_backward_plain(q, k, v, out, lse, dout, window=9)
    for a, b in zip(pairs, whole):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3), (False, 0)])
def test_flash_attention_gradcheck_float64(causal, window):
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).requires_grad_(True)
               for shape in ((1, 4, 6, 4), (1, 2, 6, 4), (1, 2, 6, 4)))
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: FlashAttention.apply(q_, k_, v_, causal, window, None), (q, k, v))


def _models(dtype, remat="nothing"):
    jcfg = jax_smoke_config(ARCH).with_(dtype=dtype)
    cfg = get_smoke_config(ARCH).with_(dtype=dtype, remat=remat)
    jm = JModel(jcfg)
    jparams, _ = jm.init(jax.random.PRNGKey(0))
    return jm, jparams, Model(cfg), params_from_numpy(_np(jparams), cfg, "cpu")


def _loss_and_grads(model, params, batch):
    flat, treedef = flatten_with_paths(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    loss = model.loss(treedef.unflatten(leaves), {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_loss_and_grads_equal_reference(dtype):
    """``Model.loss`` and its gradient in every parameter against
    ``jax.value_and_grad(Model.loss)`` on the same weights and batch (S = 70
    with ignored labels, two loss chunks and a ragged one); every remat
    policy gives the same loss and gradients bit for bit."""
    jm, jparams, model, params = _models(dtype)
    batch = _batch(jm.cfg, 70, 3, seed=1, step=2, ignore=5)
    want, wgrads = jax.value_and_grad(jm.loss)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _loss_and_grads(model, params, batch)
    assert loss.dtype == torch.float32
    wflat, _ = jax_flatten(wgrads)
    assert sorted(grads) == sorted(wflat)
    if dtype == "float32":
        assert float(loss) == pytest.approx(float(want), rel=1e-5)
        for k, g in grads.items():
            _grad_close(g, wflat[k], 1e-4)
    else:
        assert float(loss) == pytest.approx(float(want), rel=0.05, abs=0.1)
        for k, g in grads.items():
            assert g.dtype == torch.bfloat16
            _grad_close(g, wflat[k], 2e-2)
    for remat in ("dots", "full"):
        other = Model(model.cfg.with_(remat=remat))
        loss2, grads2 = _loss_and_grads(other, params, batch)
        assert torch.equal(loss2, loss), remat
        assert all(torch.equal(grads2[k], grads[k]) for k in grads), remat


def test_remat_nothing_recomputes_each_layer():
    """Under ``nothing`` each layer's forward runs again in the backward
    pass: the attention runs 2 L times a step, under ``full`` L times."""
    jm, _, model, params = _models("float32")
    batch = _batch(jm.cfg, 40, 2, seed=0, step=0)
    calls = {"n": 0}
    forward = FlashAttention.forward

    def counting(ctx, *args):
        calls["n"] += 1
        return forward(ctx, *args)

    FlashAttention.forward = staticmethod(counting)
    try:
        for remat, want in (("nothing", 2), ("full", 1)):
            calls["n"] = 0
            _loss_and_grads(Model(model.cfg.with_(remat=remat)), params, batch)
            assert calls["n"] == want * model.cfg.n_layers, remat
    finally:
        FlashAttention.forward = staticmethod(forward)


def test_input_specs():
    cfg = get_smoke_config(ARCH)
    train = input_specs(cfg, SHAPES["train_4k"])
    assert train == {"tokens": TensorSpec((256, 4096), torch.int32),
                     "labels": TensorSpec((256, 4096), torch.int32)}
    assert input_specs(cfg, SHAPES["prefill_32k"]) == {"tokens": TensorSpec((32, 32768), torch.int32)}
    dec = input_specs(cfg, SHAPES["decode_32k"])
    assert dec["pos"] == TensorSpec((), torch.int32)
    assert dec["caches"]["g0"]["k"].shape == (cfg.n_layers, 128, 32768, cfg.n_kv_heads,
                                              cfg.resolved_head_dim)
    vis = get_smoke_config("internvl2-76b")
    assert input_specs(vis, SHAPES["train_4k"])["vis_embeds"] == \
        TensorSpec((256, vis.vision_prefix, vis.d_model), torch.bfloat16)


# ---------------------------------------------------------------------------
# the train step and the state
# ---------------------------------------------------------------------------


def _jax_state(jm, jparams, opt_cfg, seed=0):
    """The reference's ``make_init_fn`` state, built without a mesh."""
    return {"params": jparams, "opt": jax_init_opt_state(jparams, opt_cfg),
            "step": jnp.zeros((), jnp.int32), "rng": jnp.asarray([0, seed + 1], jnp.uint32),
            "data": {"data_step": jnp.zeros((), jnp.int32), "seed": jnp.asarray(seed, jnp.int32)}}


def test_three_train_steps_equal_unsharded_jax_step():
    """Three steps of ``make_train_step`` against the reference's step
    written out without a mesh: ``jax.value_and_grad(Model.loss)``,
    ``warmup_cosine``, ``adamw_update``. Losses, learning rates and gradient
    norms to 1e-5; params and master within 2 lr of each other (see the
    module docstring); moments to 1e-3 of their magnitude."""
    jm, jparams, model, _ = _models("float32")
    kw = dict(peak_lr=3e-3, warmup=2, total=10)
    jopt_cfg = JaxAdamWConfig()

    @jax.jit
    def jax_step(state, batch):
        loss, grads = jax.value_and_grad(jm.loss)(state["params"], batch)
        lr = jax_warmup_cosine(state["step"], **kw)
        params, opt, om = jax_adamw_update(grads, state["opt"], state["params"], lr, jopt_cfg)
        return ({"params": params, "opt": opt, "step": state["step"] + 1, "rng": state["rng"],
                 "data": {"data_step": state["data"]["data_step"] + 1,
                          "seed": state["data"]["seed"]}},
                {"loss": loss, "lr": lr, **om})

    jstate = _jax_state(jm, jparams, jopt_cfg)
    cfg = model.cfg
    state = train_state_from_numpy(_np(jstate), cfg, AdamWConfig(), "cpu")
    step = make_train_step(cfg, AdamWConfig(), peak_lr=kw["peak_lr"], warmup=kw["warmup"],
                           total_steps=kw["total"])
    pipe = TokenPipeline(cfg, 40, 4, seed=5)
    for i in range(3):
        batch, _ = pipe.batch_at({"data_step": int(state["data"]["data_step"]), "seed": 5})
        jstate, jm_ = jax_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, batch_to_device(batch, "cpu"))
        for key in ("loss", "lr", "grad_norm"):
            assert float(m[key]) == pytest.approx(float(jm_[key]), rel=1e-5), (i, key)
    assert int(state["step"]) == int(state["data"]["data_step"]) == 3
    got, _ = flatten_with_paths(state)
    want, _ = jax_flatten(_np(jstate))
    assert list(got) == list(want)
    lr_max = kw["peak_lr"]
    for k in want:
        assert _bytes(got[k])[:2] == _bytes(want[k])[:2], k
        if k.startswith(("params", "opt/master")):
            np.testing.assert_allclose(_f32(got[k]), _f32(want[k]), atol=2 * lr_max, rtol=0,
                                       err_msg=k)
        elif k.startswith(("opt/mu", "opt/nu")):
            _grad_close(got[k], want[k], 1e-3)
        else:
            assert _bytes(got[k]) == _bytes(want[k]), k


def test_init_fn_state_has_reference_paths_and_dtypes():
    cfg = get_smoke_config(ARCH)
    state = make_init_fn(cfg, AdamWConfig(), seed=3, device="cpu")()
    got, _ = flatten_with_paths(state)
    specs, _ = flatten_with_paths(state_specs(cfg, AdamWConfig()))
    jm = JModel(jax_smoke_config(ARCH))
    want, _ = jax_flatten(jax.eval_shape(
        lambda: _jax_state(jm, jm.init(jax.random.PRNGKey(0))[0], JaxAdamWConfig(), seed=3)))
    assert list(got) == list(specs) == list(want)
    for k, t in got.items():
        assert (tuple(t.shape), t.dtype) == (specs[k].shape, specs[k].dtype), k
        assert (tuple(t.shape), str(t.dtype).removeprefix("torch.")) == \
            (tuple(want[k].shape), want[k].dtype.name), k
    assert state["rng"].tolist() == [0, 4] and int(state["data"]["seed"]) == 3
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            make_init_fn(cfg, AdamWConfig())  # the default device is the card
        else:
            raise RuntimeError("CUDA present: the default device is usable")


@pytest.mark.parametrize("bf16_moments", [False, True])
def test_train_state_cmi_crosses_packages_both_ways(tmp_path, bf16_moments):
    """A train-state CMI written by the JAX package's ``save_cmi`` restores
    in the port with equal paths, dtypes (``rng`` uint32) and bytes, and a
    state the port trained one step restores in the JAX package the same."""
    moment = "bfloat16" if bf16_moments else "float32"
    jm, jparams, model, _ = _models("bfloat16")
    jstate = _jax_state(jm, jparams, JaxAdamWConfig(moment_dtype=moment), seed=2)
    jcmi.save_cmi(tmp_path, "jax", jstate, step=0,
                  options=jser.SaveOptions(chunk_bytes=4096, cas=True))
    got, man = tcmi.restore_cmi(tmp_path, "jax", device="cpu")
    assert got["rng"].dtype == torch.uint32 and got["rng"].tolist() == [0, 3]
    gf, _ = flatten_with_paths(got)
    wf, _ = jax_flatten(_np(jstate))
    assert list(gf) == list(wf)
    assert all(_bytes(gf[k]) == _bytes(wf[k]) for k in wf)
    opt_cfg = AdamWConfig(moment_dtype=moment)
    carried = train_state_from_numpy(_np(jstate), model.cfg, opt_cfg, "cpu")
    assert all(_bytes(v) == _bytes(gf[k]) for k, v in flatten_with_paths(carried)[0].items())

    step = make_train_step(model.cfg, opt_cfg, peak_lr=1e-2, warmup=0, total_steps=4)
    batch, _ = TokenPipeline(model.cfg, 24, 2, seed=2).batch_at({"data_step": 0, "seed": 2})
    state, _ = step(got, batch_to_device(batch, "cpu"))
    tcmi.save_cmi(tmp_path, "torch", state, step=1, options=SaveOptions(chunk_bytes=4096, cas=True))
    back, jman = jcmi.restore_cmi(tmp_path, "torch")
    assert jman.step == 1 and np.asarray(back["rng"]).dtype == np.uint32
    bf, _ = jax_flatten(back)
    sf, _ = flatten_with_paths(state)
    assert list(bf) == list(sf)
    assert all(_bytes(bf[k]) == _bytes(sf[k]) for k in sf)
    assert int(np.asarray(back["step"])) == 1


# ---------------------------------------------------------------------------
# the launcher: the Fig. 7 loop on the CPU
# ---------------------------------------------------------------------------


def _run(tmp_path, name, *extra):
    store = tmp_path / name
    metrics = tmp_path / f"{name}.jsonl"
    loss = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "6",
                              "--publish-every", "3", "--seq-len", "32", "--batch", "4",
                              "--store", str(store), "--metrics", str(metrics), *extra])
    js = JobStore(store)
    (job_id, status), = js.svc_list_jobs()
    job = js.read_job(job_id)
    man = load_manifest(js.cmi_root(job_id), job.cmi)
    records = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    return loss, job, man, records


def test_launcher_preempted_run_ends_bitwise_equal_to_uninterrupted(tmp_path):
    """Reclaimed at step 4 and resumed from its CMI in a new incarnation,
    the run ends with every leaf of its step-6 CMI bitwise the uninterrupted
    run's (equal chunk digests), its step losses equal, the job finished."""
    loss_a, job_a, man_a, rec_a = _run(tmp_path, "a")
    loss_b, job_b, man_b, rec_b = _run(tmp_path, "b", "--preempt-at", "4")
    assert job_a.status == job_b.status == "finished" and job_a.step == job_b.step == 6
    leases = lambda job: [h["event"] for h in job.history if h["event"].startswith("leased:")]  # noqa: E731
    assert leases(job_a) == ["leased:instance-0"]
    assert leases(job_b) == ["leased:instance-0", "leased:instance-1"]
    assert man_a.step == man_b.step == 6
    assert {p: [c.hash for c in e.chunks] for p, e in man_a.arrays.items()} == \
        {p: [c.hash for c in e.chunks] for p, e in man_b.arrays.items()}
    assert man_a.arrays["rng"].dtype == "uint32"
    steps = lambda rec: [(r["step"], r["loss"]) for r in rec if r["event"] == "step"]  # noqa: E731
    assert steps(rec_a) == steps(rec_b) and len(steps(rec_a)) == 6
    assert loss_a == loss_b == steps(rec_a)[-1][1] and np.isfinite(loss_a)
    assert [r["step"] for r in rec_b if r["event"] == "publish"] == [3, 4, 6]
    starts = [r for r in rec_b if r["event"] == "start"]
    assert [(r["resumed"], r["step"]) for r in starts] == [(False, 0), (True, 4)]
    assert rec_b[-1]["event"] == "end" and rec_b[-1]["incarnations"] == 2
    assert not torch.are_deterministic_algorithms_enabled()  # restored on return


@pytest.mark.parametrize("flags", [["--mesh", "2x1"], ["--remesh", "1x1,2x1"]])
def test_launcher_refuses_meshes(tmp_path, flags):
    # meshes run now (tests/test_torch_mesh.py); what is refused is a cuda
    # mesh without the cards for it: nothing falls back to the CPU
    from repro_torch.distributed.group import check_devices

    with pytest.raises(RuntimeError, match="cards"):
        check_devices("cuda", torch.cuda.device_count() + 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch_train.main(["--arch", ARCH, "--smoke", "--device", "cuda",
                               "--store", str(tmp_path), *flags])
