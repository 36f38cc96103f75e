"""The port's MLA (multi-head latent attention) and the deepseek-v3-671b
model against the JAX package, on the CPU.

The JAX package's weights are carried across with ``params_from_numpy``
and inputs are made with numpy from seeds, on the smoke configuration (4
heads, q LoRA 32, KV LoRA 16, qk nope 16 + rope 8, v 16; one dense layer,
then one MoE layer of 8 experts, top 2, sigmoid routing, one shared
expert). Tolerances, with their reasons: float32 models differ by the
order of float32 sums only, so 1e-4 of each compared tensor's largest
magnitude (logits, caches, outputs, gradients) and 1e-5 relative on
losses; bf16 by where bf16 rounds (K3 keeps its probabilities float32,
the reference rounds them), so ``tests/test_models.py``'s ``atol=0.1,
rtol=0.05`` and only before the first routing (``test_torch_moe.py``).
Serve CMIs cross between the packages bit for bit.
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
from repro.models import attention as jattn
from repro.serve.engine import make_engine as jax_make_engine
from repro.serve.engine import run_reference as jax_run_reference
from repro.serve.worker import ServeHost as JServeHost
from repro.utils import flatten_with_paths as jax_flatten
from repro_torch.checkpoint import load_manifest
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import DHP, NBS, JobStore
from repro_torch.distributed import make_train_step
from repro_torch.distributed.steps import batch_to_device, make_init_fn
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import Model, params_from_numpy
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig
from repro_torch.serve import ServeHost, make_engine, run_reference
from repro_torch.utils import flatten_with_paths

ARCH = "deepseek-v3-671b"
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
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return rng, toks, labels


def _torch_batch(toks, labels):
    return {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long()}


def _jax_batch(toks, labels):
    return {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}


# ---------------------------------------------------------------------------
# the parameter and cache trees, the full configuration
# ---------------------------------------------------------------------------


def test_param_tree_and_cache_struct_equal_reference():
    """Paths, shapes and dtypes of the port's parameters (an MLA block's
    ``attn/{wq_a, q_ln, wq_b, wkv_a, kv_ln, wkv_b, wo}``, the MoE group's
    router in float32) and decode caches (the latent ``ckv`` and ``kr`` a
    group, never windowed) are the reference's."""
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jparams, _ = JModel(jcfg).init(jax.random.PRNGKey(0))
    want = {k: (v.shape, str(v.dtype)) for k, v in jax_flatten(_np(jparams))[0].items()}
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in flatten_with_paths(Model(cfg).init(torch.Generator().manual_seed(0)))[0]
           .items()}
    assert got == want
    assert {"blocks/g0/attn/wkv_b", "blocks/g1/ffn/router_bias"} <= set(got)
    jcache = JModel(jcfg).cache_struct(2, 52)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in jax_flatten(jcache)[0].items()}
    assert {k: (v.shape, str(v.dtype).removeprefix("torch."))
            for k, v in flatten_with_paths(Model(cfg).cache_struct(2, 52))[0].items()} == want
    assert set(want) == {"g0/ckv", "g0/kr", "g1/ckv", "g1/kr"}


def test_full_config_counts():
    """deepseek-v3-671b's widths (128 heads, q LoRA 1536, KV LoRA 512, qk
    128 + 64, v 128, 256 experts of 2048, top 8, 1 shared): the parameter
    tree (meta) holds the analytic count plus its vectors; a token
    multiplies ``token_params`` = the active count, which is the tree's
    matrices but the 248 unchosen experts of each MoE layer; a step's
    model FLOPs count MLA's attention at 2 (192 + 128) a visible pair and
    head. The 4-layer serving cut (3 dense + 1 MoE) holds 15.11 B
    parameters; a request's cache at 2,080 positions is ~9.6 MB."""
    cfg = get_config(ARCH)
    assert (cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
            cfg.v_head_dim, cfg.n_experts, cfg.top_k, cfg.n_shared_experts,
            cfg.resolved_moe_d_ff, cfg.first_dense_layers, cfg.opt_moment_dtype) == \
        (128, 1536, 512, 128, 64, 128, 256, 8, 1, 2048, 3, "bfloat16")
    for layers in (4, cfg.n_layers):
        c = cfg.with_(n_layers=layers)
        specs = flatten_with_paths(Model(c).param_specs())[0]
        total = sum(int(np.prod(s.shape)) for s in specs.values())
        vectors = sum(int(np.prod(s.shape)) for k, s in specs.items()
                      if len(s.shape) <= 2 and k not in ("embed", "unembed"))
        assert total - vectors == c.param_count()
        inactive = (layers - 3) * 3 * c.d_model * c.resolved_moe_d_ff * (c.n_experts - c.top_k)
        assert launch_train.token_params(c) == total - vectors - inactive
    cut = cfg.with_(n_layers=4)
    assert round(cut.param_count() / 1e9, 2) == 15.11
    assert tf.block_groups(cut) == [("g0", 3, "mla", "dense"), ("g1", 1, "mla", "moe")]
    cache = flatten_with_paths(Model(cut).cache_struct(1, 2048 + 32))[0]
    assert sum(int(np.prod(s.shape)) * 2 for s in cache.values()) == 4 * 2080 * 576 * 2
    pairs = 2048 * 2049 // 2
    assert launch_train.step_flops(cut, 1, 2048) == \
        6 * cut.active_param_count() * 2048 + 3 * 2 * 128 * (192 + 128) * pairs * 4


# ---------------------------------------------------------------------------
# the mixer and the model against the reference
# ---------------------------------------------------------------------------


def test_mla_mixer_equal_reference():
    """One MLA layer in float32: ``mla_train`` (K3 at qk nope + rope, v
    apart), the prefill's output and latent cache, and three absorbed
    decode steps writing the cache in place, against the reference's
    ``mla_train``, ``mla_prefill_cache`` and ``mla_decode``."""
    _, jparams, m, params = _models()
    cfg, jcfg = m.cfg, jax_smoke_config(ARCH).with_(dtype="float32")
    jp = {k: v[0] for k, v in jparams["blocks"]["g0"]["attn"].items()}
    tp = tf._layer(params["blocks"]["g0"]["attn"], 0)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    want = jattn.mla_train(jp, jnp.asarray(x), jcfg)
    _close(attn.mla_train(tp, torch.from_numpy(x), cfg), want)
    y, cache = attn.mla_prefill(tp, torch.from_numpy(x), cfg, S + 3)
    _close(y, want)
    jcache = jattn.mla_prefill_cache(jp, jnp.asarray(x), jcfg, S + 3)
    for key in ("ckv", "kr"):
        _close(cache[key], jcache[key])
    for i in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jcache = jattn.mla_decode(jp, jnp.asarray(xt), jcache, jnp.asarray(S + i), jcfg)
        ty, same = attn.mla_decode(tp, torch.from_numpy(xt), cache, S + i, cfg)
        assert same is cache
        _close(ty, jy)
    for key in ("ckv", "kr"):  # written in place at every position
        _close(cache[key], jcache[key])


def test_mla_prefill_runs_k3_with_v_apart():
    """The prefill calls K3 once a layer with q and k (B, H, S, nope +
    rope) and v (B, H, S, v), causal, k dense (the rope key copied into
    every head, no zero stride)."""
    cfg = get_smoke_config(ARCH)
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    seen, kernel = [], attn.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), kw["causal"],
                     0 not in k.stride()))
        return kernel(q, k, v, **kw)

    attn.flash_attention = spy
    try:
        m.prefill(params, {"tokens": torch.zeros((1, S), dtype=torch.long)}, s_max=S + 1)
    finally:
        attn.flash_attention = kernel
    h, d, dv = cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    assert seen == [((1, h, S, d), (1, h, S, d), (1, h, S, dv), True, True)] * cfg.n_layers


def test_model_loss_prefill_decode_equal_reference():
    """deepseek's smoke model in float32: ``Model.loss``, prefill logits and
    every cache leaf, then four decode steps and the caches they wrote."""
    jm, jparams, m, params = _models()
    cfg = m.cfg
    rng, toks, labels = _batch(cfg)
    loss = float(m.loss(params, _torch_batch(toks, labels)))
    assert loss == pytest.approx(float(jm.loss(jparams, _jax_batch(toks, labels))), rel=1e-5)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, s_max=S + 4)
    tl, tc = m.prefill(params, {"tokens": torch.from_numpy(toks).long()}, s_max=S + 4)
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab)
    _close(tl, jl)
    jflat, tflat = jax_flatten(_np(jc))[0], flatten_with_paths(tc)[0]
    assert sorted(jflat) == sorted(tflat)
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
    """The loss and its gradient in every parameter (the MLA LoRAs and
    norms, the router) against ``jax.value_and_grad`` in float32, the batch
    routed as one group; the router's bias, which only selects experts,
    has none in either (JAX's is zero)."""
    jm, jparams, m, params = _models()
    _, toks, labels = _batch(m.cfg, b=3, s=20, seed=5)
    want, wgrads = jax.value_and_grad(
        lambda p: jm.loss(p, _jax_batch(toks, labels), n_groups=1))(jparams)
    flat, treedef = flatten_with_paths(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    loss = m.loss(treedef.unflatten(leaves), _torch_batch(toks, labels), n_groups=1)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)))
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    wflat, _ = jax_flatten(wgrads)
    assert sorted(grads) == sorted(wflat)
    # the router's bias only selects experts: no gradient reaches it (zero in
    # JAX), and it is the one leaf the model declares so
    assert {k for k, g in grads.items() if g is None} == m.selection_only_paths() == \
        {"blocks/g1/ffn/router_bias"}
    assert grads.pop("blocks/g1/ffn/router_bias") is None
    assert not np.asarray(wflat["blocks/g1/ffn/router_bias"]).any()
    for k, g in grads.items():
        _close(g, wflat[k])
    assert float(grads["blocks/g0/attn/wkv_b"].abs().max()) > 0


def test_bf16_model_loss_and_first_layer_equal_reference():
    """bf16: the loss and the dense first group's latent caches (no routing
    decision has acted there yet) within the bf16 tolerance."""
    jm, jparams, m, params = _models("bfloat16")
    _, toks, labels = _batch(m.cfg)
    loss = float(m.loss(params, _torch_batch(toks, labels)))
    assert loss == pytest.approx(float(jm.loss(jparams, _jax_batch(toks, labels))),
                                 rel=0.05, abs=0.1)
    _, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, s_max=S + 1)
    _, tc = m.prefill(params, {"tokens": torch.from_numpy(toks).long()}, s_max=S + 1)
    for key in ("ckv", "kr"):
        assert tc["g0"][key].dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(tc["g0"][key]), _f32(jc["g0"][key]), atol=0.1,
                                   rtol=0.05)


def test_absorbed_decode_matches_teacher_forcing():
    """Absorbed decode continues the expanded prefill: prefill 20 tokens,
    decode the next 4, against the logits of one prefill of all 24 (a
    capacity factor at which no MoE assignment drops)."""
    cfg = get_smoke_config(ARCH).with_(dtype="float32")
    cfg = cfg.with_(capacity_factor=cfg.n_experts / cfg.top_k)
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (2, S)))
    want, _ = m.prefill(params, {"tokens": toks}, s_max=S)
    cut = 20
    _, caches = m.prefill(params, {"tokens": toks[:, :cut]}, s_max=S)
    for i in range(cut, S):
        lg, caches = m.decode(params, caches, toks[:, i:i + 1], i)
    _close(lg[:, 0], want)


# ---------------------------------------------------------------------------
# serving: transcripts and CMIs across the packages, the depth cut
# ---------------------------------------------------------------------------


def _float32_engines():
    """The JAX model engine in float32 and the port's with its weights."""
    jeng = jax_make_engine(f"model:{ARCH}:smoke:seed=0")
    jeng.cfg = jeng.cfg.with_(dtype="float32")
    jeng.model = JModel(jeng.cfg)
    jeng.params, _ = jeng.model.init(jax.random.PRNGKey(jeng.seed))
    jeng._decode_fn = jax.jit(lambda p, c, t, pos: jeng.model.decode(p, c, t, pos))
    eng = make_engine(jeng.spec(), device="cpu")
    eng.cfg = eng.cfg.with_(dtype="float32")
    eng.model = Model(eng.cfg)
    eng.params = params_from_numpy(_np(jeng.params), eng.cfg, "cpu")
    return jeng, eng


def _requests(n, length, max_new, seed=3):
    rng = np.random.default_rng(seed)
    return [{"id": f"d{i}", "prompt": [int(t) for t in rng.integers(0, 256, length)],
             "max_new": max_new} for i in range(n)]


def test_transcripts_match_jax_with_carried_weights():
    """Greedy transcripts equal the JAX engine's (expanded prefill, absorbed
    decode in both), float32, the JAX weights carried across."""
    jeng, eng = _float32_engines()
    reqs = _requests(3, 20, 8)
    got = run_reference(eng, reqs)
    assert got == jax_run_reference(jeng, reqs)
    assert len({tuple(t) for t in got.values()}) == len(reqs)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_serve_cmi_crosses_packages_bitwise(tmp_path, writer):
    """A deepseek request admitted and published (on admit and every 4
    steps) by one package's ServeHost, whose host is gone at done 6, is
    resumed from its CMI of done 5 by the other package's host: the latent
    caches (``blocks``' ``g0/ckv``, ``g1/kr``, ...) restored bit for bit,
    zero re-prefill, the transcript finished equal to the writer's
    ``run_reference``."""
    jeng, eng = _float32_engines()
    req = _requests(1, 18, 10, seed=9)[0]
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
        want = jax_run_reference(jeng, [req])[req["id"]]
    else:
        w_host, r_host = ServeHost(eng, dhp=tdhp, publish_every=4), JServeHost(jeng, dhp=jdhp)
        want = run_reference(eng, [req])[req["id"]]
    w_host.admit(req["id"], req["prompt"], req["max_new"], job_id=job.job_id)
    for _ in range(5):
        w_host.step()
    writer_eng = jeng if writer == "jax" else eng
    state = writer_eng.prefill(req["prompt"], req["max_new"])
    for _ in range(4):
        writer_eng.decode(state)
    res = r_host.resume(req["id"], job.job_id)
    assert res["done"] == 5
    restored = r_host.active[req["id"]]["caches"]
    if writer == "jax":
        mine = {k: v.numpy() for k, v in flatten_with_paths(restored)[0].items()}
        theirs = jax_flatten(_np(state["caches"]))[0]
    else:
        mine = jax_flatten(_np(restored))[0]
        theirs = {k: v.numpy() for k, v in flatten_with_paths(state["caches"])[0].items()}
    assert sorted(mine) == sorted(theirs) == ["g0/ckv", "g0/kr", "g1/ckv", "g1/kr"]
    for path, arr in theirs.items():
        assert mine[path].dtype == arr.dtype and mine[path].tobytes() == arr.tobytes(), path
    got = [t for _, t in res["tokens"]]
    while r_host.active:
        got += [t for _, t in r_host.step()["tokens"].get(req["id"], [])]
    assert got == want and r_host.counters["prefills"] == 0


def test_depth_cut_in_the_engine_spec():
    """``model:<arch>:full|smoke:layers=N:seed=S`` builds the configuration
    cut to N layers, widths kept, and its spec names the cut, so a worker
    that adopts or resumes a request builds the same weights; a spec
    without ``layers=`` means what it meant."""
    eng = make_engine(f"model:{ARCH}:smoke:layers=3:seed=1", device="cpu")
    assert eng.spec() == f"model:{ARCH}:smoke:layers=3:seed=1"
    assert eng.cfg == get_smoke_config(ARCH).with_(n_layers=3)
    assert tf.block_groups(eng.cfg) == [("g0", 1, "mla", "dense"), ("g1", 2, "mla", "moe")]
    again = make_engine(eng.spec(), device="cpu")
    for k, v in flatten_with_paths(eng.params)[0].items():
        assert torch.equal(v, flatten_with_paths(again.params)[0][k]), k
    plain = make_engine(f"model:{ARCH}:smoke:seed=1", device="cpu")
    assert plain.spec() == f"model:{ARCH}:smoke:seed=1" and plain.cfg == get_smoke_config(ARCH)


def test_cli_serve_with_layers_equals_run_reference(capsys):
    """``launch.serve --arch deepseek-v3-671b --smoke --layers 3 --device
    cpu``: transcripts equal ``run_reference``'s on the engine of the cut
    spec, and differ from request to request."""
    argv = ["--device", "cpu", "--arch", ARCH, "--smoke", "--layers", "3", "--gen", "6",
            "--prompt-len", "12", "--batch", "3"]
    got = launch_serve.main(argv)["transcripts"]
    reqs = launch_serve.build_requests(get_smoke_config(ARCH).vocab, batch=3, prompt_len=12,
                                       gen=6, seed=0)
    engine = make_engine(f"model:{ARCH}:smoke:layers=3:seed=0", device="cpu")
    assert got == run_reference(engine, reqs)
    assert len({tuple(t) for t in got.values()}) == 3
    assert "r002:" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the train step and the launcher
# ---------------------------------------------------------------------------


def test_train_step_zero_fills_only_the_selection_leaves():
    """``make_train_step`` gives a zero gradient only to the leaves the
    model declares selection-only (the sigmoid router's bias; a softmax
    router has none), so the bias stays zero; any other leaf the loss does
    not reach makes the step raise."""
    assert Model(get_smoke_config("granite-moe-1b-a400m")).selection_only_paths() == set()
    cfg = get_smoke_config(ARCH)
    state = make_init_fn(cfg, AdamWConfig(), seed=0, device="cpu")()
    _, toks, labels = _batch(cfg, b=2, s=16, seed=6)
    batch = batch_to_device({"tokens": toks, "labels": labels}, "cpu")
    step = make_train_step(cfg, AdamWConfig(), peak_lr=1e-2, warmup=0)
    state, metrics = step(state, batch)
    assert torch.isfinite(metrics["loss"]) and float(metrics["grad_norm"]) > 0
    assert not state["params"]["blocks"]["g1"]["ffn"]["router_bias"].any()
    state["params"]["blocks"]["g0"]["stray"] = torch.zeros(3)
    with pytest.raises(RuntimeError, match="not have been used"):
        step(state, batch)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_bf16_moments_preempted_run_ends_bitwise_equal(tmp_path):
    """deepseek's smoke config through the Fig. 7 launcher: its bf16
    optimizer moments (``opt_moment_dtype``) reach the port's AdamW and the
    CMI; reclaimed at step 2 and resumed, the run ends with every chunk
    digest of its final CMI and every step loss equal to the uninterrupted
    run's, every loss finite."""

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
    assert man_a.step == man_b.step == 4
    assert man_a.arrays["opt/mu/blocks/g0/attn/wq_a"].dtype == "bfloat16"
    assert man_a.arrays["opt/master/blocks/g0/attn/wq_a"].dtype == "float32"
    assert {p: [c.hash for c in e.chunks] for p, e in man_a.arrays.items()} == \
        {p: [c.hash for c in e.chunks] for p, e in man_b.arrays.items()}
    steps = lambda rec: [(r["step"], r["loss"]) for r in rec if r["event"] == "step"]  # noqa: E731
    assert steps(rec_a) == steps(rec_b) and len(steps(rec_a)) == 4
    assert all(np.isfinite(loss) for _, loss in steps(rec_a))
    assert [(r["resumed"], r["step"]) for r in rec_b if r["event"] == "start"] == \
        [(False, 0), (True, 2)]
    start = next(r for r in rec_a if r["event"] == "start")
    assert start["model_flops_per_step"] == launch_train.step_flops(get_smoke_config(ARCH), 2, 24)
