"""The hymba-1.5b (attention ‖ SSD) and xlstm-1.3b (mLSTM) models of the
port against the JAX package's, on the CPU.

The JAX package's weights are carried across with ``params_from_numpy``
and inputs are made with numpy from seeds, on the smoke configurations
(hymba's window is 32 tokens). Sequences of 48 tokens pass the window but
stay within one ``attn_q_block``, so the reference's windowed attention
fault (ROADMAP queue 3) does not bite. Tolerances, with their reasons:
float32 models differ by the order of float32 sums only, so 1e-4 on
logits and caches, 1e-5 relative on losses and 1e-4 of the largest
magnitude on gradients; bf16 models by where bf16 rounds (K3 keeps its
probabilities float32), so ``tests/test_models.py``'s ``atol=0.1,
rtol=0.05``. Serve CMIs cross between the packages bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import DHP as JDHP, NBS as JNBS, JobStore as JJobStore
from repro.models import Model as JModel
from repro.serve.engine import make_engine as jax_make_engine
from repro.serve.engine import run_reference as jax_run_reference
from repro.serve.engine import transcript as jax_transcript
from repro.serve.worker import ServeHost as JServeHost
from repro.utils import flatten_with_paths as jax_flatten
from repro_torch.checkpoint import load_manifest
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import DHP, NBS, JobStore
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import Model, params_from_numpy
from repro_torch.serve import ServeHost, make_engine, run_reference
from repro_torch.serve.engine import transcript
from repro_torch.utils import flatten_with_paths

ARCHS = ["hymba-1.5b", "xlstm-1.3b"]
F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=0.1, rtol=0.05)
S = 48  # past hymba's smoke window of 32, within one attn_q_block


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)  # writable copies


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _models(arch, dtype="float32"):
    jcfg = jax_smoke_config(arch).with_(dtype=dtype)
    cfg = get_smoke_config(arch).with_(dtype=dtype)
    jm = JModel(jcfg)
    jparams, _ = jm.init(jax.random.PRNGKey(0))
    return jm, jparams, Model(cfg), params_from_numpy(_np(jparams), cfg, "cpu")


def _batch(cfg, b=2, s=S, seed=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return rng, toks, labels


def _specs(tree):
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in flatten_with_paths(tree)[0].items()}


# ---------------------------------------------------------------------------
# the parameter and cache trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_cache_struct_equal_reference(arch):
    """Paths, shapes and dtypes of the port's parameters (bf16, the float32
    gate parameters kept) and decode caches (bf16 k/v, float32 recurrent
    states) are the reference's; an mLSTM block has no ``ln2`` or ``ffn``."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jparams, _ = JModel(jcfg).init(jax.random.PRNGKey(0))
    want = {k: (v.shape, str(v.dtype)) for k, v in jax_flatten(_np(jparams))[0].items()}
    assert _specs(Model(cfg).init(torch.Generator().manual_seed(0))) == want
    jcache = JModel(jcfg).cache_struct(2, 52)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in jax_flatten(jcache)[0].items()}
    assert {k: (v.shape, str(v.dtype).removeprefix("torch."))
            for k, v in flatten_with_paths(Model(cfg).cache_struct(2, 52))[0].items()} == want
    assert ("ffn" in jparams["blocks"]["g0"]) == (arch == "hymba-1.5b")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_build(arch):
    """``Model(get_config(arch))`` builds, its parameter tree (on the meta
    device) holding the parameters a training step counts
    (``launch.train.token_params``) plus its vectors (norms, gate biases)."""
    cfg = get_config(arch)
    specs = flatten_with_paths(Model(cfg).param_specs())[0]
    total = sum(int(np.prod(s.shape)) for s in specs.values())
    vectors = sum(int(np.prod(s.shape)) for k, s in specs.items()  # (L, X) or (X,) leaves
                  if len(s.shape) <= 2 and k not in ("embed", "unembed"))
    assert total - vectors == launch_train.token_params(cfg)


def test_step_flops_counts_each_mixer():
    """A step's model FLOPs: 6 N T, plus attention's 12 B H D a visible
    pair (within hymba's window of 2048) where the mixer has attention,
    plus three times the chunked recurrence's products; xlstm has no
    attention term."""
    hy, xl = get_config("hymba-1.5b"), get_config("xlstm-1.3b")
    b, s = 2, 4096
    pairs = 2048 * 2049 // 2 + (4096 - 2048) * 2048
    rec_hy = 2 * b * s * 25 * (128 * (16 + 64) + 2 * 16 * 64)
    assert launch_train.recurrence_flops(hy, b, s) == rec_hy
    assert launch_train.step_flops(hy, b, s) == \
        6 * hy.param_count() * b * s + 32 * (12 * b * 25 * 64 * pairs + 3 * rec_hy)
    rec_xl = 2 * 4 * 2048 * 4 * (128 * (512 + 513) + 2 * 512 * 513)
    assert launch_train.recurrence_flops(xl, 4, 2048) == rec_xl
    assert launch_train.step_flops(xl, 4, 2048) == \
        6 * launch_train.token_params(xl) * 4 * 2048 + 48 * 3 * rec_xl
    # a ragged sequence is padded to whole chunks
    assert launch_train.recurrence_flops(xl, 1, 129) == launch_train.recurrence_flops(xl, 1, 256)
    qwen = get_config("qwen3-1.7b")
    assert launch_train.recurrence_flops(qwen, b, s) == 0


# ---------------------------------------------------------------------------
# the models against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_prefill_decode_equal_reference(arch):
    """float32: ``Model.loss``, prefill logits and every cache leaf at S =
    48, then four decode steps (hymba's rolling window cache wraps)."""
    jm, jparams, m, params = _models(arch)
    cfg = m.cfg
    rng, toks, labels = _batch(cfg)
    loss = float(m.loss(params, {"tokens": torch.from_numpy(toks).long(),
                                 "labels": torch.from_numpy(labels).long()}))
    want = float(jm.loss(jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}))
    assert loss == pytest.approx(want, rel=1e-5)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, s_max=S + 4)
    tl, tc = m.prefill(params, {"tokens": torch.from_numpy(toks).long()}, s_max=S + 4)
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    jflat, tflat = jax_flatten(_np(jc))[0], flatten_with_paths(tc)[0]
    assert sorted(jflat) == sorted(tflat)
    for path, want in jflat.items():
        np.testing.assert_allclose(_f32(tflat[path]), want, **F32)
    for i in range(4):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jm.decode(jparams, jc, jnp.asarray(tok), jnp.asarray(S + i, jnp.int32))
        tl, tc = m.decode(params, tc, torch.from_numpy(tok).long(), S + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    for path, want in jax_flatten(_np(jc))[0].items():  # the states decode wrote in place
        np.testing.assert_allclose(_f32(flatten_with_paths(tc)[0][path]), want, **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_equal_reference(arch):
    """The loss and its gradient in every parameter against
    ``jax.value_and_grad(Model.loss)`` in float32."""
    jm, jparams, m, params = _models(arch)
    _, toks, labels = _batch(m.cfg, b=3, s=40, seed=5)
    want, wgrads = jax.value_and_grad(lambda p: jm.loss(
        p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}))(jparams)
    flat, treedef = flatten_with_paths(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    loss = m.loss(treedef.unflatten(leaves), {"tokens": torch.from_numpy(toks).long(),
                                              "labels": torch.from_numpy(labels).long()})
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    wflat, _ = jax_flatten(wgrads)
    assert sorted(grads) == sorted(wflat)
    for k, g in grads.items():
        g, w = _f32(g), np.asarray(wflat[k], np.float32)
        assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-12), k


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing_past_the_window(arch):
    """Decode continues prefill: prefill 36 tokens (past the window), decode
    the next 12 one by one, against the logits of one prefill of all 48."""
    cfg = get_smoke_config(arch).with_(dtype="float32")
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (2, S)))
    want, _ = m.prefill(params, {"tokens": toks}, s_max=S)
    cut = 36
    _, caches = m.prefill(params, {"tokens": toks[:, :cut]}, s_max=S)
    for i in range(cut, S):
        lg, caches = m.decode(params, caches, toks[:, i:i + 1], i)
    np.testing.assert_allclose(lg[:, 0].numpy(), want.numpy(), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_model_loss_and_logits_equal_reference(arch):
    """bf16: the loss and the prefill logits within the bf16 tolerance."""
    jm, jparams, m, params = _models(arch, "bfloat16")
    _, toks, labels = _batch(m.cfg)
    loss = float(m.loss(params, {"tokens": torch.from_numpy(toks).long(),
                                 "labels": torch.from_numpy(labels).long()}))
    want = float(jm.loss(jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}))
    assert loss == pytest.approx(want, rel=0.05, abs=0.1)
    jl, _ = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, s_max=S + 1)
    tl, _ = m.prefill(params, {"tokens": torch.from_numpy(toks).long()}, s_max=S + 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BF16)


# ---------------------------------------------------------------------------
# serving: transcripts and CMIs across the packages
# ---------------------------------------------------------------------------


def _float32_engines(arch):
    """The JAX model engine in float32 and the port's with its weights."""
    jeng = jax_make_engine(f"model:{arch}:smoke:seed=0")
    jeng.cfg = jeng.cfg.with_(dtype="float32")
    jeng.model = JModel(jeng.cfg)
    jeng.params, _ = jeng.model.init(jax.random.PRNGKey(jeng.seed))
    jeng._decode_fn = jax.jit(lambda p, c, t, pos: jeng.model.decode(p, c, t, pos))
    eng = make_engine(jeng.spec(), device="cpu")
    eng.cfg = eng.cfg.with_(dtype="float32")
    eng.model = Model(eng.cfg)
    eng.params = params_from_numpy(_np(jeng.params), eng.cfg, "cpu")
    return jeng, eng


@pytest.mark.parametrize("arch", ARCHS)
def test_transcripts_match_jax_with_carried_weights(arch):
    """Greedy transcripts equal the JAX engine's, prompts past the window."""
    jeng, eng = _float32_engines(arch)
    rng = np.random.default_rng(3)
    reqs = [{"id": f"h{i}", "prompt": [int(t) for t in rng.integers(0, 256, 40)], "max_new": 8}
            for i in range(2)]
    got = run_reference(eng, reqs)
    assert got == jax_run_reference(jeng, reqs)
    assert len({tuple(t) for t in got.values()}) == len(reqs)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cmi_crosses_packages_bitwise(tmp_path, arch, writer):
    """A request admitted and published (on admit and every 4 steps) by one
    package's ServeHost, whose host is gone at done 6, is resumed from its
    CMI of done 5 by the other package's host: every cache leaf (k/v, the
    SSD state, the mLSTM memory) restored bit for bit, zero re-prefill, the
    transcript finished equal to the writer's ``run_reference``."""
    jeng, eng = _float32_engines(arch)
    req = {"id": "c0", "prompt": [int(t) for t in np.random.default_rng(9).integers(0, 256, 36)],
           "max_new": 10}
    jjs = JJobStore(tmp_path / "jobs")
    job = jjs.create_job({"app": "serve", "req": req["id"]})
    jnbs = JNBS(tmp_path / "jstore")
    jnbs.add_node("j0", mesh=None)
    nbs = NBS(tmp_path / "tstore")
    nbs.add_node("t0", device="cpu")
    js = JobStore(tmp_path / "jobs")
    jdhp, tdhp = JDHP(jnbs, "j0", jjs, chunk_bytes=4096), DHP(nbs, "t0", js, chunk_bytes=4096)
    if writer == "jax":
        w_host, r_host = JServeHost(jeng, dhp=jdhp, publish_every=4), ServeHost(eng, dhp=tdhp)
        want = jax_run_reference(jeng, [req])["c0"]
    else:
        w_host, r_host = ServeHost(eng, dhp=tdhp, publish_every=4), JServeHost(jeng, dhp=jdhp)
        want = run_reference(eng, [req])["c0"]
    w_host.admit(req["id"], req["prompt"], req["max_new"], job_id=job.job_id)
    for _ in range(5):
        w_host.step()
    # the writer's own state at done 5, the CMI's content
    writer_eng = jeng if writer == "jax" else eng
    state = writer_eng.prefill(req["prompt"], req["max_new"])
    for _ in range(4):
        writer_eng.decode(state)
    res = r_host.resume(req["id"], job.job_id)
    assert res["done"] == 5
    restored = r_host.active[req["id"]]["caches"]
    if writer == "jax":
        mine, theirs = flatten_with_paths(restored)[0], jax_flatten(_np(state["caches"]))[0]
        mine = {k: v.numpy() for k, v in mine.items()}
    else:
        mine = jax_flatten(_np(restored))[0]
        theirs = {k: v.numpy() for k, v in flatten_with_paths(state["caches"])[0].items()}
    assert sorted(mine) == sorted(theirs) and any(k.endswith(("ssd", "mlstm")) for k in mine)
    for path, arr in theirs.items():
        assert mine[path].dtype == arr.dtype and mine[path].tobytes() == arr.tobytes(), path
    got = [t for _, t in res["tokens"]]
    while r_host.active:
        got += [t for _, t in r_host.step()["tokens"].get(req["id"], [])]
    assert got == want and r_host.counters["prefills"] == 0
    assert (jax_transcript(state) if writer == "jax" else transcript(state)) == want[:5]


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serve_smoke_equals_run_reference(arch, capsys):
    """``launch.serve --arch <arch> --smoke --device cpu`` with prompts past
    hymba's window: transcripts equal ``run_reference``'s and differ from
    request to request."""
    argv = ["--device", "cpu", "--arch", arch, "--smoke", "--gen", "6", "--prompt-len", "40",
            "--batch", "3"]
    got = launch_serve.main(argv)["transcripts"]
    reqs = launch_serve.build_requests(get_smoke_config(arch).vocab, batch=3, prompt_len=40,
                                       gen=6, seed=0)
    assert got == run_reference(make_engine(f"model:{arch}:smoke:seed=0", device="cpu"), reqs)
    assert len({tuple(t) for t in got.values()}) == 3
    assert "r002:" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_preempted_run_ends_bitwise_equal_to_uninterrupted(tmp_path, arch):
    """The smoke config through the Fig. 7 launcher at sequences past the
    window: reclaimed at step 2 and resumed, the run ends with every chunk
    digest of its final CMI and every step loss equal to the uninterrupted
    run's, every loss finite."""

    def run(name, *extra):
        store, metrics = tmp_path / name, tmp_path / f"{name}.jsonl"
        launch_train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "4",
                           "--publish-every", "2", "--seq-len", "40", "--batch", "2",
                           "--store", str(store), "--metrics", str(metrics), *extra])
        js = JobStore(store)
        (job_id, _), = js.svc_list_jobs()
        job = js.read_job(job_id)
        man = load_manifest(js.cmi_root(job_id), job.cmi)
        return job, man, [json.loads(ln) for ln in metrics.read_text().splitlines()]

    job_a, man_a, rec_a = run("a")
    job_b, man_b, rec_b = run("b", "--preempt-at", "2")
    assert job_a.status == job_b.status == "finished" and man_a.step == man_b.step == 4
    assert {p: [c.hash for c in e.chunks] for p, e in man_a.arrays.items()} == \
        {p: [c.hash for c in e.chunks] for p, e in man_b.arrays.items()}
    steps = lambda rec: [(r["step"], r["loss"]) for r in rec if r["event"] == "step"]  # noqa: E731
    assert steps(rec_a) == steps(rec_b) and len(steps(rec_a)) == 4
    assert all(np.isfinite(loss) for _, loss in steps(rec_a))
    assert [(r["resumed"], r["step"]) for r in rec_b if r["event"] == "start"] == \
        [(False, 0), (True, 2)]
    start = next(r for r in rec_a if r["event"] == "start")
    assert start["model_flops_per_step"] == launch_train.step_flops(get_smoke_config(arch), 2, 40)
