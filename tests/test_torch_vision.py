"""The port's vision prefix (internvl2-76b) against the JAX package, on the
CPU.

The JAX package's weights are carried across with ``params_from_numpy``
and inputs are made with numpy from seeds, on the smoke configuration (2
layers, d_model 64, 4 heads, 2 kv heads, an 8-embedding prefix, q block
1024). Every total length here (prefix + tokens) is not a multiple of the
q block, so the last q block is ragged, as internvl2's 256 + 2048 = 2304
positions are against 1024 at full width. Tolerances, with their
reasons: float32 models differ by the order of float32 sums only, so 1e-4
of each compared tensor's largest magnitude and 1e-5 relative on losses;
bf16 by where bf16 rounds (K3 keeps its probabilities float32), so
``tests/test_models.py``'s ``atol=0.1, rtol=0.05``. The pipeline's patch
embeddings are bitwise equal.
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
from repro.models.model import input_specs as jax_input_specs
from repro.configs import SHAPES as JSHAPES
from repro.utils import flatten_with_paths as jax_flatten
from repro_torch.checkpoint import load_manifest
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.core import JobStore
from repro_torch.data import TokenPipeline
from repro_torch.distributed.steps import batch_to_device
from repro_torch.launch import train as launch_train
from repro_torch.models import Model, TensorSpec, input_specs, params_from_numpy
from repro_torch.serve import make_engine
from repro_torch.utils import flatten_with_paths

ARCH = "internvl2-76b"
S = 21  # 8 + 21 = 29 positions: one ragged q block


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
    """numpy tokens, labels and float32 patch embeddings; the JAX and
    torch batches."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    vis = (rng.standard_normal((b, cfg.vision_prefix, cfg.d_model)) * 0.1).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "vis_embeds": jnp.asarray(vis)}
    tb = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long(),
          "vis_embeds": torch.from_numpy(vis)}
    return rng, jb, tb


def test_config_loads_and_input_specs_equal_reference():
    """internvl2 loads in the port (nothing refuses the prefix), its
    parameter tree is the reference's, and ``input_specs`` gives the
    patch embeddings for train and prefill as the reference does."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    specs = flatten_with_paths(Model(cfg).param_specs())[0]
    jparams = jax.eval_shape(lambda k: JModel(jcfg).init(k)[0], jax.random.PRNGKey(0))
    assert {k: s.shape for k, s in specs.items()} == \
        {k: tuple(v.shape) for k, v in jax_flatten(jparams)[0].items()}
    for kind in ("train_4k", "prefill_32k"):
        want = jax_input_specs(jcfg, JSHAPES[kind])
        got = input_specs(cfg, SHAPES[kind])
        assert sorted(got) == sorted(want)
        assert got["vis_embeds"] == TensorSpec(tuple(want["vis_embeds"].shape), torch.bfloat16)
    assert "vis_embeds" not in input_specs(cfg, SHAPES["decode_32k"])


@pytest.mark.parametrize("step,seed", [(0, 0), (3, 11)])
def test_pipeline_patch_embeddings_bitwise_equal_reference(step, seed):
    """``vis_embeds``: the reference's float32 Philox normals, drawn after
    the tokens, rounded to bf16 and times bf16 0.1 (``ml_dtypes``), here
    rounded on the bits and carried as uint16: every bit equal, and the
    tokens and labels too; ``batch_to_device`` views them as bf16."""
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    want, _ = JaxTokenPipeline(jcfg, 19, 3, seed=seed).batch_at({"data_step": step, "seed": seed})
    got, nxt = TokenPipeline(cfg, 19, 3, seed=seed).batch_at({"data_step": step, "seed": seed})
    assert nxt == {"data_step": step + 1, "seed": seed} and sorted(got) == sorted(want)
    vis = got["vis_embeds"]
    assert vis.dtype == np.uint16 and vis.shape == (3, cfg.vision_prefix, cfg.d_model)
    assert vis.tobytes() == np.asarray(want["vis_embeds"]).view(np.int16).tobytes()
    for key in ("tokens", "labels"):
        assert got[key].tobytes() == np.asarray(want[key]).tobytes()
    on_device = batch_to_device(got, "cpu")
    assert on_device["vis_embeds"].dtype == torch.bfloat16
    assert on_device["vis_embeds"].view(torch.int16).numpy().tobytes() == vis.tobytes()


def test_model_loss_prefill_decode_equal_reference():
    """float32: ``Model.loss``, prefill over prefix + tokens (29 positions,
    a ragged q block) with its logits and every cache leaf, then four
    decode steps from position S + P."""
    jm, jparams, m, params = _models()
    cfg = m.cfg
    rng, jb, tb = _batch(cfg)
    assert float(m.loss(params, tb)) == pytest.approx(float(jm.loss(jparams, jb)), rel=1e-5)
    total = S + cfg.vision_prefix
    assert total % cfg.attn_q_block != 0
    pb = ("tokens", "vis_embeds")
    jl, jc = jm.prefill(jparams, {k: jb[k] for k in pb}, s_max=total + 4)
    tl, tc = m.prefill(params, {k: tb[k] for k in pb}, s_max=total + 4)
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab)
    _close(tl, jl)
    jflat, tflat = jax_flatten(_np(jc))[0], flatten_with_paths(tc)[0]
    assert sorted(jflat) == sorted(tflat) == ["g0/k", "g0/v"]
    assert tflat["g0/k"].shape[2] == total + 4
    for path, want in jflat.items():
        _close(tflat[path], want)
    for i in range(4):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jm.decode(jparams, jc, jnp.asarray(tok), jnp.asarray(total + i, jnp.int32))
        tl, tc = m.decode(params, tc, torch.from_numpy(tok).long(), total + i)
        _close(tl, jl)
    for path, want in jax_flatten(_np(jc))[0].items():
        _close(flatten_with_paths(tc)[0][path], want)


def test_loss_masks_the_prefix():
    """The loss over prefix + tokens equals the same computation with the
    prefix's positions dropped from the labels: the hidden states of the
    whole sequence, the loss taken over the token positions alone."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import embed, softmax_xent_chunked

    _, _, m, params = _models()
    cfg = m.cfg
    _, _, tb = _batch(cfg, seed=7)
    x = torch.cat([tb["vis_embeds"], embed(tb["tokens"], params["embed"]).float()], dim=1)
    h = tf.forward_train(params, x, cfg)
    want = softmax_xent_chunked(h[:, cfg.vision_prefix:], params["unembed"], tb["labels"],
                                cfg.loss_chunk)
    assert float(m.loss(params, tb)) == pytest.approx(float(want), rel=1e-6)


def test_bf16_model_loss_and_logits_equal_reference():
    """bf16: the loss and the prefill logits within the bf16 tolerance."""
    jm, jparams, m, params = _models("bfloat16")
    _, jb, tb = _batch(m.cfg)
    assert float(m.loss(params, tb)) == pytest.approx(float(jm.loss(jparams, jb)), rel=0.05,
                                                      abs=0.1)
    pb = ("tokens", "vis_embeds")
    jl, _ = jm.prefill(jparams, {k: jb[k] for k in pb}, s_max=S + 9)
    tl, _ = m.prefill(params, {k: tb[k].to(torch.bfloat16) if k == "vis_embeds" else tb[k]
                               for k in pb}, s_max=S + 9)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.1, rtol=0.05)


def test_serving_refuses_the_vision_prefix():
    """Both packages' engines serve decoder-only models without a prefix;
    internvl2 is trained and run in process here, not served."""
    with pytest.raises(ValueError, match="decoder-only"):
        make_engine(f"model:{ARCH}:smoke:seed=0", device="cpu")


def test_launcher_preempted_run_ends_bitwise_equal_to_uninterrupted(tmp_path):
    """internvl2's smoke config through the Fig. 7 launcher (the pipeline's
    patch embeddings through ``batch_to_device``): reclaimed at step 2 and
    resumed, the run ends with every chunk digest of its final CMI and
    every step loss equal to the uninterrupted run's, every loss finite;
    the start record's model FLOPs count the prefix."""

    def run(name, *extra):
        store, metrics = tmp_path / name, tmp_path / f"{name}.jsonl"
        launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "4",
                           "--publish-every", "2", "--seq-len", str(S), "--batch", "2",
                           "--store", str(store), "--metrics", str(metrics), *extra])
        js = JobStore(store)
        (job_id, _), = js.svc_list_jobs()
        man = load_manifest(js.cmi_root(job_id), js.read_job(job_id).cmi)
        return man, [json.loads(ln) for ln in metrics.read_text().splitlines()]

    man_a, rec_a = run("a")
    man_b, rec_b = run("b", "--preempt-at", "2")
    assert man_a.step == man_b.step == 4 and "params/unembed" in man_a.arrays
    assert {p: [c.hash for c in e.chunks] for p, e in man_a.arrays.items()} == \
        {p: [c.hash for c in e.chunks] for p, e in man_b.arrays.items()}
    steps = lambda rec: [(r["step"], r["loss"]) for r in rec if r["event"] == "step"]  # noqa: E731
    assert steps(rec_a) == steps(rec_b) and len(steps(rec_a)) == 4
    assert all(np.isfinite(loss) for _, loss in steps(rec_a))
    assert [(r["resumed"], r["step"]) for r in rec_b if r["event"] == "start"] == \
        [(False, 0), (True, 2)]
    cfg = get_smoke_config(ARCH)
    start = next(r for r in rec_a if r["event"] == "start")
    assert start["model_flops_per_step"] == launch_train.step_flops(cfg, 2, S)
    assert launch_train.step_flops(cfg, 2, S) == \
        launch_train.step_flops(cfg.with_(vision_prefix=0), 2, S + cfg.vision_prefix)
