"""The port's MoE FFN and the granite-moe-1b-a400m model against the JAX
package, on the CPU.

The JAX package's weights are carried across with ``params_from_numpy``
and inputs are made with numpy from seeds. Tolerances, with their reasons:

* float32 configurations: the packages differ by the order of float32 sums
  (the router and expert products, the scatter-add that combines a
  token's k expert outputs), so 1e-4 on values and logits, 1e-5 relative
  on losses, 1e-4 of the largest magnitude on gradients;
* bf16: where the frameworks round to bf16 (the combine sums in the
  parameter dtype in another order, K3 keeps its probabilities float32),
  the ``atol=0.1, rtol=0.05`` of ``tests/test_models.py``'s decode check,
  and only before a routing decision (see the bf16 test).

Which (token, expert) assignments pass capacity is compared exactly: each
expert's down projection is made to write only its own output column, so
an output column is non-zero exactly where its expert's assignment was
kept, in either package. The resume and serving checks are the port
against itself, bitwise.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import Model as JModel
from repro.models import moe as jmoe
from repro.utils import flatten_with_paths as jax_flatten
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import JobStore
from repro_torch.checkpoint import load_manifest
from repro_torch.distributed import make_train_step
from repro_torch.distributed.steps import batch_to_device, make_init_fn
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import Model, params_from_numpy
from repro_torch.models import moe
from repro_torch.optim import AdamWConfig
from repro_torch.serve import make_engine, run_reference
from repro_torch.utils import flatten_with_paths

ARCH = "granite-moe-1b-a400m"
F32 = dict(atol=1e-4, rtol=1e-4)
TOL = {"float32": F32, "bfloat16": dict(atol=0.1, rtol=0.05)}

# variants of the smoke config (8 experts, top 2, d_model 64), each with
# the routing or layout it exercises
VARIANTS = {
    "softmax": {},
    "sigmoid_bias": dict(router_type="sigmoid"),
    "shared_expert": dict(n_shared_experts=1),
    "dropping": dict(capacity_factor=0.5),
    "first_dense": dict(first_dense_layers=1),
}


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)  # writable copies


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _grad_close(got, want, rel):
    got, want = _f32(got), _f32(want)
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-12)


def _cfgs(dtype="float32", **kw):
    return (jax_smoke_config(ARCH).with_(dtype=dtype, **kw),
            get_smoke_config(ARCH).with_(dtype=dtype, **kw))


def _models(dtype="float32", seed=0, edit=None, **kw):
    """(JAX model, its params, the port's model, the same params carried
    across); ``edit(tree)`` changes the JAX tree (numpy leaves) first."""
    jcfg, cfg = _cfgs(dtype, **kw)
    jm = JModel(jcfg)
    jparams, _ = jm.init(jax.random.PRNGKey(seed))
    tree = _np(jparams)
    if edit is not None:
        edit(tree)
        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jm, jparams, Model(cfg), params_from_numpy(tree, cfg, "cpu")


def _moe_group(params) -> str:
    return "g1" if "g1" in params["blocks"] else "g0"


def _layer0(tree):
    return {k: v[0] for k, v in tree.items()}


def _random_router_bias(tree):
    ffn = tree["blocks"]["g0"]["ffn"]
    ffn["router_bias"] = np.random.default_rng(7).normal(
        0, 0.5, ffn["router_bias"].shape).astype(np.float32)


def _own_column_experts(tree):
    """Expert x's down projection writes output column x only."""
    ffn = tree["blocks"][_moe_group(tree)]["ffn"]
    wd = np.zeros_like(ffn["wd"])
    x_ = wd.shape[1]
    wd[:, np.arange(x_), :, np.arange(x_)] = 1.0 + np.abs(
        np.random.default_rng(8).standard_normal((x_, wd.shape[0], wd.shape[2])))
    ffn["wd"] = wd


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 5, 8])
def test_top_k_breaks_ties_like_jax(k):
    """Values in descending order, ties to the lower index, on rows made
    of few distinct values (many ties, across the k boundary too)."""
    x = np.random.default_rng(k).integers(-2, 3, (64, 8)).astype(np.float32)
    vals, idx = moe.top_k(torch.from_numpy(x), k)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_route_equals_reference(router):
    jcfg, cfg = _cfgs(router_type=router)
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((40, cfg.n_experts)).astype(np.float32)
    bias = {"router_bias": rng.normal(0, 0.3, cfg.n_experts).astype(np.float32)}
    gates, idx = moe._route(torch.from_numpy(logits), {k: torch.from_numpy(v)
                                                        for k, v in bias.items()}, cfg)
    jg, ji = jmoe._route(jnp.asarray(logits), {k: jnp.asarray(v) for k, v in bias.items()}, jcfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    assert gates.dtype == torch.float32
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the FFN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_groups", [0, 1, 4])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moe_ffn_equals_reference(variant, n_groups):
    """One MoE layer's output on the same input and carried weights, at
    routing groups of one sequence (0), the whole batch (1) and halves of
    sequences (4)."""
    edit = _random_router_bias if variant == "sigmoid_bias" else None
    jm, jparams, model, params = _models(edit=edit, **VARIANTS[variant])
    g = _moe_group(params)
    cfg, jcfg = model.cfg, jm.cfg
    p = _layer0(params["blocks"][g]["ffn"])
    jp = _layer0(jparams["blocks"][g]["ffn"])
    assert p["w_router"].dtype == torch.float32
    x = np.random.default_rng(11).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    got = moe.moe_ffn(p, torch.from_numpy(x), cfg, n_groups=n_groups)
    want = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, n_groups=n_groups)
    assert got.shape == (2, 16, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _kept(out: np.ndarray, n_experts: int) -> set:
    """(token, expert) pairs whose expert wrote its column."""
    t, x = np.nonzero(out.reshape(-1, out.shape[-1])[:, :n_experts])
    return set(zip(t.tolist(), x.tolist()))


@pytest.mark.parametrize("router", ["random", "all_tied", "tied_pairs"])
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_kept_assignments_equal_the_reference(router, cf):
    """The set of (token, expert) assignments that pass capacity is the
    reference's: with a random router, with every logit tied (top-k must
    pick experts 0..k-1) and with experts in tied pairs (equal router
    columns), at a capacity factor that drops assignments and at the
    default."""

    def edit(tree):
        _own_column_experts(tree)
        w = tree["blocks"]["g0"]["ffn"]["w_router"]
        if router == "all_tied":
            w[...] = 0.0
        elif router == "tied_pairs":
            w[..., 1::2] = w[..., 0::2]

    jm, jparams, model, params = _models(edit=edit, capacity_factor=cf)
    cfg = model.cfg
    x = np.random.default_rng(12).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    got = moe.moe_ffn(_layer0(params["blocks"]["g0"]["ffn"]), torch.from_numpy(x), cfg)
    want = jmoe.moe_ffn(_layer0(jparams["blocks"]["g0"]["ffn"]), jnp.asarray(x), jm.cfg)
    kept = _kept(got.numpy(), cfg.n_experts)
    assert kept == _kept(np.asarray(want), cfg.n_experts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    cap = moe.capacity(24, cfg)
    per_expert = np.zeros((2, cfg.n_experts), int)
    for t, e in kept:
        per_expert[t // 24, e] += 1
    assert per_expert.max() <= cap
    if cf < 1:
        assert len(kept) < 2 * 24 * cfg.top_k  # some were dropped
    if router == "all_tied":
        assert {e for _, e in kept} <= set(range(cfg.top_k))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["softmax", "first_dense", "sigmoid_bias"])
def test_param_tree_equals_reference(variant):
    """Paths, shapes and dtypes of the port's init are the reference's (the
    router float32 in a bf16 model), and ``params_from_numpy`` refuses a
    router of another dtype."""
    jcfg, cfg = _cfgs("bfloat16", **VARIANTS[variant])
    jparams, _ = JModel(jcfg).init(jax.random.PRNGKey(0))
    want = {k: (v.shape, str(v.dtype)) for k, v in jax_flatten(_np(jparams))[0].items()}
    mine = Model(cfg).init(torch.Generator().manual_seed(0))
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in flatten_with_paths(mine)[0].items()}
    assert got == want
    g = _moe_group(mine)
    assert mine["blocks"][g]["ffn"]["w_router"].dtype == torch.float32
    assert mine["blocks"][g]["ffn"]["wg"].dtype == torch.bfloat16
    tree = _np(jparams)
    tree["blocks"][g]["ffn"]["w_router"] = tree["blocks"][g]["ffn"]["w_router"].astype(
        jnp.bfloat16)
    with pytest.raises(ValueError, match="w_router"):
        params_from_numpy(tree, cfg, "cpu")


def _inputs(cfg):
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    return rng, toks, labels


@pytest.mark.parametrize("variant", ["softmax", "first_dense", "dropping", "shared_expert"])
def test_model_loss_prefill_decode_equal_reference(variant):
    """granite's smoke model in float32: ``Model.loss``, prefill logits and
    every layer's caches, three decode steps."""
    jm, jparams, m, params = _models("float32", **VARIANTS[variant])
    cfg = m.cfg
    rng, toks, labels = _inputs(cfg)
    loss = float(m.loss(params, {"tokens": torch.from_numpy(toks).long(),
                                 "labels": torch.from_numpy(labels).long()}))
    assert loss == pytest.approx(float(jm.loss(jparams, {"tokens": jnp.asarray(toks),
                                                         "labels": jnp.asarray(labels)})),
                                 rel=1e-5)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, s_max=28)
    tl, tc = m.prefill(params, {"tokens": torch.from_numpy(toks).long()}, s_max=28)
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    assert set(tc) == set(jc)
    for g in tc:
        for key in ("k", "v"):
            np.testing.assert_allclose(_f32(tc[g][key]), _f32(jc[g][key]), **F32)
    for i in range(3):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jm.decode(jparams, jc, jnp.asarray(tok), jnp.asarray(24 + i, jnp.int32))
        tl, tc = m.decode(params, tc, torch.from_numpy(tok).long(), 24 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)


@pytest.mark.parametrize("variant", ["softmax", "dropping"])
def test_bf16_model_loss_and_first_layer_equal_reference(variant):
    """In bf16 the packages round in different places (K3 keeps its
    probabilities float32), and a token whose k-th and (k+1)-th router
    logits lie within that rounding may pick another expert, which moves
    the later layers and, through capacity, other tokens. So the bf16 model
    is held to the reference where no routing decision has acted yet (the
    first layer's caches) and on the loss, a mean over all tokens; the
    float32 test above holds every value."""
    jm, jparams, m, params = _models("bfloat16", **VARIANTS[variant])
    _, toks, labels = _inputs(m.cfg)
    loss = float(m.loss(params, {"tokens": torch.from_numpy(toks).long(),
                                 "labels": torch.from_numpy(labels).long()}))
    want = float(jm.loss(jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}))
    assert loss == pytest.approx(want, rel=0.05, abs=0.1)
    _, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, s_max=28)
    _, tc = m.prefill(params, {"tokens": torch.from_numpy(toks).long()}, s_max=28)
    for key in ("k", "v"):
        assert tc["g0"][key].dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(tc["g0"][key][0]), _f32(jc["g0"][key][0]),
                                   **TOL["bfloat16"])


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_loss_gradients_equal_reference(cf):
    """The loss and its gradient in every parameter, the router's included,
    against ``jax.value_and_grad(Model.loss)`` in float32, with the batch
    routed as one group (the train step's ``n_groups`` on one device);
    dropped assignments (cf 0.5) pass zero gradient in both."""
    jm, jparams, m, params = _models(capacity_factor=cf)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, m.cfg.vocab, (3, 20)).astype(np.int32)
    labels = rng.integers(0, m.cfg.vocab, (3, 20)).astype(np.int32)
    want, wgrads = jax.value_and_grad(lambda p: jm.loss(
        p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}, n_groups=1))(jparams)
    flat, treedef = flatten_with_paths(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    loss = m.loss(treedef.unflatten(leaves), {"tokens": torch.from_numpy(toks).long(),
                                              "labels": torch.from_numpy(labels).long()},
                  n_groups=1)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    wflat, _ = jax_flatten(wgrads)
    assert sorted(grads) == sorted(wflat)
    for k, g in grads.items():
        _grad_close(g, wflat[k], 1e-4)
    assert float(grads["blocks/g0/ffn/w_router"].abs().max()) > 0


def test_moe_decode_matches_teacher_forcing():
    """Decode continues prefill where no assignment drops: at a capacity
    factor of n_experts / top_k every group's capacity holds all of its
    tokens, at prefill (one group of S tokens) and at decode (one token)."""
    cfg = get_smoke_config(ARCH)
    cfg = cfg.with_(capacity_factor=cfg.n_experts / cfg.top_k)
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (2, 24)))
    want, _ = m.prefill(params, {"tokens": toks}, s_max=24)
    cut = 22
    _, caches = m.prefill(params, {"tokens": toks[:, :cut]}, s_max=24)
    for i in range(cut, 24):
        lg, caches = m.decode(params, caches, toks[:, i:i + 1], i)
    np.testing.assert_allclose(lg[:, 0].numpy(), want.numpy(), atol=0.1, rtol=0.05)


def test_full_config_counts():
    """The configuration the card runs: 24 layers of 32 experts, top 8, at
    1.335 B parameters and 0.429 B active a token; a step's model FLOPs
    count the active ones."""
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.n_experts, cfg.top_k, cfg.resolved_moe_d_ff, cfg.vocab) == \
        (24, 1024, 16, 8, 64, 32, 8, 512, 49155)
    assert round(cfg.param_count() / 1e9, 3) == 1.335
    assert round(cfg.active_param_count() / 1e9, 3) == 0.429
    specs = flatten_with_paths(Model(cfg).param_specs())[0]
    norms = (2 * cfg.n_layers + 1) * cfg.d_model  # param_count leaves the norms out
    assert sum(int(np.prod(s.shape)) for s in specs.values()) == cfg.param_count() + norms
    pairs = 2048 * 2049 // 2
    assert launch_train.step_flops(cfg, 4, 2048) == \
        6 * cfg.active_param_count() * 4 * 2048 + 12 * 4 * 16 * 64 * pairs * 24
    assert moe.capacity(2048, cfg) == 640 and moe.capacity(1, cfg) == 1


# ---------------------------------------------------------------------------
# the train step and the launcher
# ---------------------------------------------------------------------------


def test_train_step_routes_the_batch_as_one_group():
    """``make_train_step``'s default ``n_route_groups`` (the data-parallel
    degree, 1 on one device) gives the loss of ``Model.loss(n_groups=1)``
    and the reference's loss with the same groups; the mesh-only
    ``moe_buf_shard`` raises."""
    jm, jparams, m, params = _models(capacity_factor=0.5)
    cfg = m.cfg
    with pytest.raises(NotImplementedError, match="item 11"):
        make_train_step(cfg, AdamWConfig(), moe_buf_shard=True)
    state = make_init_fn(cfg, AdamWConfig(), seed=0, device="cpu")()
    state["params"] = params
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    want = float(jm.loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, n_groups=1))
    one = float(m.loss(params, batch_to_device(batch, "cpu"), n_groups=1))
    _, metrics = make_train_step(cfg, AdamWConfig())(state, batch_to_device(batch, "cpu"))
    assert float(metrics["loss"]) == one == pytest.approx(want, rel=1e-5)


def test_launcher_preempted_run_ends_bitwise_equal_to_uninterrupted(tmp_path):
    """granite's smoke config through the Fig. 7 launcher: reclaimed at step
    2 and resumed, the run ends with every chunk digest of its final CMI and
    every step loss equal to the uninterrupted run's."""

    def run(name, *extra):
        store, metrics = tmp_path / name, tmp_path / f"{name}.jsonl"
        launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "4",
                           "--publish-every", "2", "--seq-len", "32", "--batch", "4",
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
    assert man_a.arrays["params/blocks/g0/ffn/w_router"].dtype == "float32"
    steps = lambda rec: [(r["step"], r["loss"]) for r in rec if r["event"] == "step"]  # noqa: E731
    assert steps(rec_a) == steps(rec_b) and len(steps(rec_a)) == 4
    assert [(r["resumed"], r["step"]) for r in rec_b if r["event"] == "start"] == \
        [(False, 0), (True, 2)]
    start = next(r for r in rec_a if r["event"] == "start")
    cfg = get_smoke_config(ARCH)
    assert start["model_flops_per_step"] == launch_train.step_flops(cfg, 4, 32)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_cli_serve_smoke_equals_run_reference(capsys):
    """``launch.serve --arch granite-moe-1b-a400m --smoke --device cpu``:
    transcripts equal ``run_reference``'s, and a request's transcript does
    not depend on the requests served beside it (each is its own routing
    group)."""
    argv = ["--device", "cpu", "--arch", ARCH, "--smoke", "--gen", "6", "--prompt-len", "12",
            "--batch", "3"]
    got = launch_serve.main(argv)["transcripts"]
    reqs = launch_serve.build_requests(get_smoke_config(ARCH).vocab, batch=3, prompt_len=12,
                                       gen=6, seed=0)
    engine = make_engine(f"model:{ARCH}:smoke:seed=0", device="cpu")
    assert got == run_reference(engine, reqs)
    for req in reqs:  # alone
        assert run_reference(engine, [req]) == {req["id"]: got[req["id"]]}
    assert len({tuple(t) for t in got.values()}) == 3
    assert "r002:" in capsys.readouterr().out


def test_transcripts_match_jax_with_carried_weights():
    """The JAX model engine and the port's, float32, the JAX weights
    carried across: equal greedy transcripts."""
    from repro.serve.engine import make_engine as jax_make_engine
    from repro.serve.engine import run_reference as jax_run_reference

    jeng = jax_make_engine(f"model:{ARCH}:smoke:seed=0")
    jeng.cfg = jeng.cfg.with_(dtype="float32")
    jeng.model = JModel(jeng.cfg)
    jeng.params, _ = jeng.model.init(jax.random.PRNGKey(jeng.seed))
    jeng._decode_fn = jax.jit(lambda p, c, t, pos: jeng.model.decode(p, c, t, pos))
    eng = make_engine(jeng.spec(), device="cpu")
    eng.cfg = eng.cfg.with_(dtype="float32")
    eng.model = Model(eng.cfg)
    eng.params = params_from_numpy(_np(jeng.params), eng.cfg, "cpu")
    reqs = [{"id": f"m{i}", "prompt": [7 * i + 1, 200, 13, 64 + i, 9], "max_new": 8}
            for i in range(3)]
    got = run_reference(eng, reqs)
    assert got == jax_run_reference(jeng, reqs)
    assert len({tuple(t) for t in got.values()}) == len(reqs)
