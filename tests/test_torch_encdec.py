"""The port's encoder-decoder and the whisper-tiny model against the JAX
package, on the CPU.

The JAX package's weights are carried across with ``params_from_numpy``
and inputs are made with numpy from seeds, on the smoke configuration (2
encoder and 2 decoder layers, d_model 64, 4 heads, 64 frames, biases,
tied embeddings). Tolerances, with their reasons: float32 models differ
by the order of float32 sums only, so 1e-4 of each compared tensor's
largest magnitude (logits, caches, hidden states, gradients) and 1e-5
relative on losses; bf16 by where bf16 rounds (K3 keeps its
probabilities float32), so ``tests/test_models.py``'s ``atol=0.1,
rtol=0.05``. The audio frames of the data pipeline are bitwise equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline
from repro.models import Model as JModel
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.utils import flatten_with_paths as jax_flatten
from repro_torch.checkpoint import load_manifest
from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.core import JobStore
from repro_torch.data import TokenPipeline
from repro_torch.distributed.steps import batch_to_device
from repro_torch.launch import train as launch_train
from repro_torch.models import Model, TensorSpec, input_specs, params_from_numpy
from repro_torch.models import attention as attn
from repro_torch.models import encdec
from repro_torch.models.layers import gelu_mlp, layernorm
from repro_torch.serve import make_engine
from repro_torch.utils import flatten_with_paths

ARCH = "whisper-tiny"
S = 24


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)  # writable copies


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, rel=1e-4):
    """Within ``rel`` of the reference's largest magnitude."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-12)


def _models(dtype="float32"):
    jcfg = jax_smoke_config(ARCH).with_(dtype=dtype)
    cfg = get_smoke_config(ARCH).with_(dtype=dtype)
    jm = JModel(jcfg)
    jparams, _ = jm.init(jax.random.PRNGKey(0))
    return jm, jparams, Model(cfg), params_from_numpy(_np(jparams), cfg, "cpu")


def _batch(cfg, b=2, s=S, seed=4):
    """numpy tokens, labels and float32 frames; the JAX and torch batches."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    frames = rng.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "enc_frames": jnp.asarray(frames)}
    tb = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long(),
          "enc_frames": torch.from_numpy(frames)}
    return rng, jb, tb


# ---------------------------------------------------------------------------
# layers, trees, the pipeline's frames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_and_tanh_gelu_mlp_equal_reference(dtype):
    """``layernorm`` (float32 statistics, one rounding to the input dtype)
    and ``gelu_mlp`` with GELU's tanh approximation, ``jax.nn.gelu``'s
    default: float32 to 1e-5 of the max, bf16 within the bf16 tolerance.
    The exact erf GELU (PyTorch's default) is further from the reference
    than float32's tolerance."""
    rng = np.random.default_rng(2)
    x, s, b = (rng.standard_normal(shape).astype(np.float32) for shape in ((3, 5, 64), (64,),
                                                                          (64,)))
    w_in, b_in = rng.standard_normal((64, 96)).astype(np.float32) / 8, rng.standard_normal(96)
    w_out, b_out = rng.standard_normal((96, 64)).astype(np.float32) / 10, rng.standard_normal(64)
    arrays = [x, s, b, w_in, b_in.astype(np.float32), w_out, b_out.astype(np.float32)]
    jx, js, jb, jwi, jbi, jwo, jbo = (jnp.asarray(a, dtype=dtype) for a in arrays)
    tx, ts, tb, twi, tbi, two, tbo = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=0.1, rtol=0.05)
    ln = layernorm(tx, ts, tb, 1e-5)
    assert ln.dtype == tx.dtype
    np.testing.assert_allclose(_f32(ln), _f32(jlayers.layernorm(jx, js, jb, 1e-5)), **tol)
    want = _f32(jlayers.gelu_mlp(jx, jwi, jbi, jwo, jbo))
    np.testing.assert_allclose(_f32(gelu_mlp(tx, twi, tbi, two, tbo)), want, **tol)
    if dtype == "float32":
        h = torch.matmul(tx, twi) + tbi
        erf = torch.matmul(torch.nn.functional.gelu(h), two) + tbo
        assert np.abs(_f32(erf) - want).max() > 1e-4


def test_param_tree_and_cache_struct_equal_reference():
    """Paths, shapes and dtypes of the parameters (``pos_enc``, ``pos_dec``
    of 32,768 rows, the encoder and decoder stacks, tied ``embed``) and the
    flat decode caches (self k/v, cross ``xk``/``xv`` over the frames) are
    the reference's; ``input_specs`` adds the frames to train and prefill."""
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jparams, _ = JModel(jcfg).init(jax.random.PRNGKey(0))
    want = {k: (v.shape, str(v.dtype)) for k, v in jax_flatten(_np(jparams))[0].items()}
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in flatten_with_paths(params)[0].items()} == want
    assert params["pos_dec"].shape[0] == encdec.MAX_DEC_POS and "unembed" not in params
    jcache = JModel(jcfg).cache_struct(2, 52)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in jax_flatten(jcache)[0].items()}
    assert {k: (v.shape, str(v.dtype).removeprefix("torch."))
            for k, v in flatten_with_paths(Model(cfg).cache_struct(2, 52))[0].items()} == want
    frames = TensorSpec((256, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    assert input_specs(cfg, SHAPES["train_4k"])["enc_frames"] == frames
    assert input_specs(cfg, SHAPES["prefill_32k"])["enc_frames"].shape == (32, 64, 64)


@pytest.mark.parametrize("step,seed", [(0, 0), (3, 11)])
def test_pipeline_frames_bitwise_equal_reference(step, seed):
    """``enc_frames``: the reference's float32 Philox normals rounded to bf16
    and times bf16 0.1 (``ml_dtypes``), here rounded on the bits with
    numpy and carried as uint16 bits: every bit equal, and the tokens and
    labels too; ``batch_to_device`` gives them as a bf16 tensor, and the
    rounding agrees with torch's bf16 cast and product."""
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    want, _ = JaxTokenPipeline(jcfg, 33, 3, seed=seed).batch_at({"data_step": step, "seed": seed})
    got, nxt = TokenPipeline(cfg, 33, 3, seed=seed).batch_at({"data_step": step, "seed": seed})
    assert nxt == {"data_step": step + 1, "seed": seed} and sorted(got) == sorted(want)
    frames = got["enc_frames"]
    assert frames.dtype == np.uint16 and frames.shape == (3, cfg.enc_seq, cfg.d_model)
    assert frames.tobytes() == np.asarray(want["enc_frames"]).view(np.int16).tobytes()
    for key in ("tokens", "labels"):
        assert got[key].tobytes() == np.asarray(want[key]).tobytes()
    on_device = batch_to_device(got, "cpu")
    assert on_device["enc_frames"].dtype == torch.bfloat16
    assert on_device["enc_frames"].view(torch.int16).numpy().tobytes() == frames.tobytes()
    assert on_device["tokens"].dtype == torch.int32
    draw = np.random.Generator(np.random.Philox(key=seed, counter=step))
    draw.zipf(1.3, size=(3, 34))
    draw = draw.standard_normal(frames.shape, dtype=np.float32)
    torch_bf16 = torch.from_numpy(draw).to(torch.bfloat16) * torch.tensor(0.1, dtype=torch.bfloat16)
    assert torch.equal(on_device["enc_frames"].view(torch.int16), torch_bf16.view(torch.int16))


def test_full_config_counts():
    """whisper-tiny at full width (4 + 4 layers, d_model 384, 6 heads of 64,
    1,500 frames, vocab 51,865, tied): the tree's matrices are what
    ``encdec_token_params`` counts, frames' and tokens' together; a step's
    model FLOPs count the frames, the tokens and the three attentions."""
    cfg = get_config(ARCH)
    assert (cfg.enc_layers, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.resolved_head_dim,
            cfg.enc_seq, cfg.vocab, cfg.tie_embeddings) == (4, 4, 384, 6, 64, 1500, 51865, True)
    specs = flatten_with_paths(Model(cfg).param_specs())[0]
    total = sum(int(np.prod(s.shape)) for s in specs.values())
    vectors = sum(int(np.prod(s.shape)) for k, s in specs.items()  # norms, biases, pos tables
                  if (len(s.shape) <= 2 and k != "embed") or k.endswith(("/bq", "/bk", "/bv")))
    frame, token = launch_train.encdec_token_params(cfg)
    assert total - vectors == frame + token
    b, s = 4, 2048
    pairs = 4 * 1500 ** 2 + 4 * (s * (s + 1) // 2 + s * 1500)
    assert launch_train.step_flops(cfg, b, s) == \
        6 * b * (frame * 1500 + token * s) + 3 * b * 4 * 6 * 64 * pairs
    with pytest.raises(ValueError, match="encdec_token_params"):
        launch_train.token_params(cfg)


# ---------------------------------------------------------------------------
# the stacks and the model against the reference
# ---------------------------------------------------------------------------


def test_encode_and_decode_train_equal_reference():
    """float32: ``encode`` (non-causal K3 over the frames) and
    ``decode_train`` (causal self and cross K3) against the reference's."""
    _, jparams, m, params = _models()
    cfg, jcfg = m.cfg, jax_smoke_config(ARCH).with_(dtype="float32")
    _, jb, tb = _batch(cfg)
    jenc = jencdec.encode(jparams, jb["enc_frames"], jcfg)
    tenc = encdec.encode(params, tb["enc_frames"], cfg)
    _close(tenc, jenc)
    _close(encdec.decode_train(params, tb["tokens"], tenc, cfg),
           jencdec.decode_train(jparams, jb["tokens"], jenc, jcfg))


def test_every_attention_goes_through_k3():
    """The training forward calls K3 for each encoder layer (non-causal,
    Sq = Sk = frames), each decoder layer's self-attention (causal) and
    cross-attention (non-causal, Sq tokens against Sk frames); under
    autograd each layer's recompute calls it again."""
    cfg = get_smoke_config(ARCH)
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    _, _, tb = _batch(cfg, b=1)
    seen, kernel = [], attn.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[2], k.shape[2], kw["causal"]))
        return kernel(q, k, v, **kw)

    attn.flash_attention = spy
    try:
        with torch.no_grad():
            m.loss(params, tb)
        once = list(seen)
        seen.clear()
        flat, treedef = flatten_with_paths(params)
        leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
        torch.autograd.grad(m.loss(treedef.unflatten(leaves), tb), list(leaves.values()))
    finally:
        attn.flash_attention = kernel
    t = cfg.enc_seq
    assert once == [(t, t, False)] * cfg.enc_layers + [(S, S, True), (S, t, False)] * cfg.n_layers
    assert sorted(seen) == sorted(once * 2)


def test_model_loss_prefill_decode_equal_reference():
    """float32: ``Model.loss``, prefill logits and every cache leaf (self
    k/v padded, cross k/v), then four decode steps (the decoder position
    added at ``pos``) and the self k/v they wrote in place."""
    jm, jparams, m, params = _models()
    cfg = m.cfg
    rng, jb, tb = _batch(cfg)
    loss = float(m.loss(params, tb))
    assert loss == pytest.approx(float(jm.loss(jparams, jb)), rel=1e-5)
    pb = {k: jb[k] for k in ("tokens", "enc_frames")}
    jl, jc = jm.prefill(jparams, pb, s_max=S + 4)
    tl, tc = m.prefill(params, {k: tb[k] for k in ("tokens", "enc_frames")}, s_max=S + 4)
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab)
    _close(tl, jl)
    jflat, tflat = jax_flatten(_np(jc))[0], flatten_with_paths(tc)[0]
    assert sorted(jflat) == sorted(tflat) == ["k", "v", "xk", "xv"]
    for path, want in jflat.items():
        _close(tflat[path], want)
    for i in range(4):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jm.decode(jparams, jc, jnp.asarray(tok), jnp.asarray(S + i, jnp.int32))
        tl, tc = m.decode(params, tc, torch.from_numpy(tok).long(), S + i)
        _close(tl, jl)
    for path, want in jax_flatten(_np(jc))[0].items():
        _close(flatten_with_paths(tc)[0][path], want)


def test_loss_gradients_equal_reference():
    """The loss and its gradient in every parameter (both stacks, the
    position tables, the tied embedding) against ``jax.value_and_grad`` in
    float32; the key biases' gradients, 0 but for rounding, are held to
    1e-6 of the largest gradient in both."""
    jm, jparams, m, params = _models()
    _, jb, tb = _batch(m.cfg, b=3, s=20, seed=5)
    want, wgrads = jax.value_and_grad(lambda p: jm.loss(p, jb))(jparams)
    flat, treedef = flatten_with_paths(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    loss = m.loss(treedef.unflatten(leaves), tb)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    wflat, _ = jax_flatten(wgrads)
    assert sorted(grads) == sorted(wflat)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in wflat.values())
    for k, g in grads.items():
        if k.endswith("/bk"):
            # a key bias adds q.b to every score of a row, which softmax
            # cancels: its gradient is 0 up to rounding in both packages
            assert max(np.abs(_f32(g)).max(), np.abs(_f32(wflat[k])).max()) <= 1e-6 * scale, k
        else:
            _close(g, wflat[k])
    assert float(grads["enc/attn/wk"].abs().max()) > 0 and float(grads["pos_enc"].abs().max()) > 0


def test_bf16_model_loss_and_logits_equal_reference():
    """bf16: the loss and the prefill logits within the bf16 tolerance."""
    jm, jparams, m, params = _models("bfloat16")
    _, jb, tb = _batch(m.cfg)
    assert float(m.loss(params, tb)) == pytest.approx(float(jm.loss(jparams, jb)), rel=0.05,
                                                      abs=0.1)
    jl, _ = jm.prefill(jparams, {k: jb[k] for k in ("tokens", "enc_frames")}, s_max=S + 1)
    tl, _ = m.prefill(params, {k: tb[k] for k in ("tokens", "enc_frames")}, s_max=S + 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.1, rtol=0.05)


def test_decode_matches_teacher_forcing():
    """Decode continues prefill: prefill 18 tokens, decode the next 6 one by
    one (self attention over the cache, cross over the frames' k/v),
    against the logits of one prefill of all 24."""
    cfg = get_smoke_config(ARCH).with_(dtype="float32")
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    _, _, tb = _batch(cfg)
    toks, frames = tb["tokens"], tb["enc_frames"]
    want, _ = m.prefill(params, {"tokens": toks, "enc_frames": frames}, s_max=S)
    cut = 18
    _, caches = m.prefill(params, {"tokens": toks[:, :cut], "enc_frames": frames}, s_max=S)
    for i in range(cut, S):
        lg, caches = m.decode(params, caches, toks[:, i:i + 1], i)
    _close(lg[:, 0], want)


def test_serving_refuses_the_encoder_decoder():
    """Both packages' engines serve decoder-only models; whisper is trained
    here, not served."""
    with pytest.raises(ValueError, match="decoder-only"):
        make_engine(f"model:{ARCH}:smoke:seed=0", device="cpu")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_preempted_run_ends_bitwise_equal_to_uninterrupted(tmp_path):
    """whisper's smoke config through the Fig. 7 launcher (the pipeline's
    frames through ``batch_to_device``): reclaimed at step 2 and resumed,
    the run ends with every chunk digest of its final CMI and every step
    loss equal to the uninterrupted run's, every loss finite; the start
    record's model FLOPs count the frames."""

    def run(name, *extra):
        store, metrics = tmp_path / name, tmp_path / f"{name}.jsonl"
        launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "4",
                           "--publish-every", "2", "--seq-len", "24", "--batch", "2",
                           "--store", str(store), "--metrics", str(metrics), *extra])
        js = JobStore(store)
        (job_id, _), = js.svc_list_jobs()
        man = load_manifest(js.cmi_root(job_id), js.read_job(job_id).cmi)
        return man, [json.loads(ln) for ln in metrics.read_text().splitlines()]

    man_a, rec_a = run("a")
    man_b, rec_b = run("b", "--preempt-at", "2")
    assert man_a.step == man_b.step == 4 and "params/pos_dec" in man_a.arrays
    assert {p: [c.hash for c in e.chunks] for p, e in man_a.arrays.items()} == \
        {p: [c.hash for c in e.chunks] for p, e in man_b.arrays.items()}
    steps = lambda rec: [(r["step"], r["loss"]) for r in rec if r["event"] == "step"]  # noqa: E731
    assert steps(rec_a) == steps(rec_b) and len(steps(rec_a)) == 4
    assert all(np.isfinite(loss) for _, loss in steps(rec_a))
    assert [(r["resumed"], r["step"]) for r in rec_b if r["event"] == "start"] == \
        [(False, 0), (True, 2)]
    start = next(r for r in rec_a if r["event"] == "start")
    assert start["model_flops_per_step"] == launch_train.step_flops(get_smoke_config(ARCH), 2, 24)
