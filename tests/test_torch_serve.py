"""The port's serving slice on the CPU, against the JAX package's.

Transcripts are a pure function of (engine, prompt, max_new): the toy
engine's are bit-identical across packages; the model engine's are held
with the JAX package's weights carried across (``params_from_numpy``) in
the float32 configuration, where the two packages' logits differ by the
order of float32 sums only (1e-4, ``test_torch_models.py``), so the greedy
transcripts are equal. Requests are published as CMIs and resumed with
zero re-prefill, also across packages: in float32 to an equal transcript,
and in bf16 (caches crossing as int16 views) to bit-identical caches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DHP as JDHP, NBS as JNBS, JobStore as JJobStore
from repro.models import Model as JModel
from repro.serve.engine import make_engine as jax_make_engine
from repro.serve.engine import run_reference as jax_run_reference
from repro.serve.engine import transcript as jax_transcript
from repro.serve.worker import ServeHost as JServeHost
from repro_torch.checkpoint.fsck import fsck_store
from repro_torch.core import DHP, NBS, JobStore
from repro_torch.core.jobstore import STATUS_FINISHED
from repro_torch.fabric.stream import StreamHopError
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Model, params_from_numpy
from repro_torch.serve import ServeHost, ToyEngine, make_engine, run_reference

TOY = "toy:d=64,vocab=256,seed=3"
MODEL = "model:qwen3-1.7b:smoke:seed=0"
REQS = [{"id": f"q{i}", "prompt": [5 + 3 * i, 40, 17 + i, 8], "max_new": 12} for i in range(4)]
BF16_LOGITS_TOL = dict(atol=0.1, rtol=0.05)  # tests/test_models.py's bf16 decode check


def _float32(jax_engine):
    """The JAX model engine rebuilt in the float32 configuration from its seed."""
    cfg = jax_engine.cfg.with_(dtype="float32")
    jax_engine.cfg, jax_engine.model = cfg, JModel(cfg)
    jax_engine.params, _ = jax_engine.model.init(jax.random.PRNGKey(jax_engine.seed))
    jax_engine._decode_fn = jax.jit(lambda p, c, t, pos: jax_engine.model.decode(p, c, t, pos))
    return jax_engine


def _carried_engine(jax_engine):
    """The port's model engine on the CPU, in the JAX engine's configuration
    and with its weights."""
    eng = make_engine(jax_engine.spec(), device="cpu")
    eng.cfg = eng.cfg.with_(dtype=jax_engine.cfg.dtype)
    eng.model = Model(eng.cfg)
    eng.params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_engine.params),
                                   eng.cfg, "cpu")
    return eng


def _store(tmp_path, node="s0"):
    nbs = NBS(tmp_path / "store")
    nbs.add_node(node, device="cpu")
    js = JobStore(tmp_path / "jobs")
    return js, DHP(nbs, node, js, chunk_bytes=4096)


def _run_host(host, got):
    while host.active:
        for rid, toks in host.step()["tokens"].items():
            got[rid].extend(tok for _, tok in toks)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def test_toy_transcripts_bit_identical_to_jax():
    got = run_reference(make_engine(TOY), REQS)
    assert got == jax_run_reference(jax_make_engine(TOY), REQS)
    assert all(len(set(t)) > 1 for t in got.values())
    assert len({tuple(t) for t in got.values()}) == len(REQS)
    state = ToyEngine(d=16, vocab=64).prefill([1, 2, 3], 8)
    assert state["kv"].dtype == np.float64 and state["pos"] == 3


def test_model_engine_deterministic_rebuild():
    reqs = [{"id": "m0", "prompt": [3, 1, 4, 1, 5], "max_new": 6}]
    a = run_reference(make_engine(MODEL, device="cpu"), reqs)
    b = run_reference(make_engine(make_engine(MODEL, device="cpu").spec(), device="cpu"), reqs)
    assert a == b and len(a["m0"]) == 6
    with pytest.raises(ValueError):
        make_engine(MODEL, device="cpu").prefill([], 4)


def test_model_transcripts_match_jax_with_carried_weights():
    jeng = _float32(jax_make_engine(MODEL))
    eng = _carried_engine(jeng)
    reqs = [{"id": f"m{i}", "prompt": [7 * i + 1, 200, 13, 64 + i, 9], "max_new": 8}
            for i in range(3)]
    got = run_reference(eng, reqs)
    assert got == jax_run_reference(jeng, reqs)
    assert len({tuple(t) for t in got.values()}) == len(reqs)


# ---------------------------------------------------------------------------
# the rolling batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [TOY, MODEL])
def test_rolling_batch_staggered_admits(spec):
    expected = run_reference(make_engine(spec, device="cpu"), REQS)
    host = ServeHost(make_engine(spec, device="cpu"))
    got = {}
    for req in REQS:  # each admit lands while earlier requests are decoding
        res = host.admit(req["id"], req["prompt"], req["max_new"])
        got[req["id"]] = [tok for _, tok in res["tokens"]]
        for rid, toks in host.step()["tokens"].items():
            got[rid].extend(tok for _, tok in toks)
    _run_host(host, got)
    assert got == expected
    assert host.counters["prefills"] == len(REQS)
    assert host.status()["requests"] == {}
    host.admit("dup", [1, 2], 4)
    with pytest.raises(ValueError, match="already active"):
        host.admit("dup", [1, 2], 4)


@pytest.mark.parametrize("spec", [TOY, MODEL])
def test_publish_drop_resume_zero_reprefill(tmp_path, spec):
    js, dhp = _store(tmp_path)
    req = REQS[1]
    expected = run_reference(make_engine(spec, device="cpu"), [req])[req["id"]]
    job = js.create_job({"app": "serve", "req": req["id"]})
    host = ServeHost(make_engine(spec, device="cpu"), dhp=dhp, publish_every=3)
    host.admit(req["id"], req["prompt"], req["max_new"], job_id=job.job_id)
    for _ in range(5):  # publishes at done = 1 (admit) and 4; dies at done 6
        host.step()
    assert host.counters["publishes"] == 2
    assert host.drop(req["id"]) == {"dropped": True}

    _, dhp2 = _store(tmp_path, node="s1")
    host2 = ServeHost(make_engine(spec, device="cpu"), dhp=dhp2, publish_every=3)
    res = host2.resume(req["id"], job.job_id)
    assert res["done"] == 4 and [t for _, t in res["tokens"]] == expected[:4]
    got = {req["id"]: [t for _, t in res["tokens"]]}
    _run_host(host2, got)
    assert got[req["id"]] == expected
    assert host2.counters["prefills"] == 0 and host2.counters["resumes"] == 1
    assert js.read_job(job.job_id).status == STATUS_FINISHED
    assert fsck_store(js.cmi_root(job.job_id)).clean


def _published_by_jax_host(tmp_path, jeng, req):
    """A JAX ServeHost admits ``req`` under a job, publishing on admit and
    every 4 steps, and is gone at done 6: its last CMI is of done 5.
    Returns the job and the JAX engine's own state at done 5."""
    jnbs = JNBS(tmp_path / "jstore")
    jnbs.add_node("j0", mesh=None)
    jjs = JJobStore(tmp_path / "jobs")
    job = jjs.create_job({"app": "serve", "req": req["id"]})
    jhost = JServeHost(jeng, dhp=JDHP(jnbs, "j0", jjs, chunk_bytes=4096), publish_every=4)
    jhost.admit(req["id"], req["prompt"], req["max_new"], job_id=job.job_id)
    for _ in range(5):
        jhost.step()
    state = jeng.prefill(req["prompt"], req["max_new"])
    for _ in range(4):
        jeng.decode(state)
    return job, state


def _resume_here(tmp_path, jeng, req, job, state):
    """The port's host resumes the JAX host's CMI from the same job store;
    the restored caches are the JAX engine's, bit for bit."""
    _, dhp = _store(tmp_path, node="t0")
    host = ServeHost(_carried_engine(jeng), dhp=dhp)
    res = host.resume(req["id"], job.job_id)
    assert res["done"] == 5 and [t for _, t in res["tokens"]] == jax_transcript(state)
    caches = host.active[req["id"]]["caches"]["g0"]
    for name in ("k", "v"):
        want = np.asarray(state["caches"]["g0"][name])
        assert caches[name].dtype == getattr(torch, jeng.cfg.dtype)
        assert tuple(caches[name].shape) == want.shape == (2, 1, 16, 2, 16)
        assert caches[name].view(torch.int16 if want.itemsize == 2 else torch.int32).numpy() \
            .tobytes() == want.tobytes()
    return host, [t for _, t in res["tokens"]]


def test_request_published_by_jax_host_finishes_here(tmp_path):
    """A JAX ServeHost admits and publishes; the port's host resumes the CMI
    (float32 caches, numpy token arrays) and finishes it with carried
    weights, to the JAX package's transcript."""
    jeng = _float32(jax_make_engine(MODEL))
    req = {"id": "x0", "prompt": [11, 2, 99, 7, 40, 3], "max_new": 10}
    want = jax_run_reference(jeng, [req])["x0"]
    job, state = _published_by_jax_host(tmp_path, jeng, req)
    host, got = _resume_here(tmp_path, jeng, req, job, state)
    got = {"x0": got}
    _run_host(host, got)
    assert host.counters["prefills"] == 0 and host.counters["resumes"] == 1
    assert got["x0"] == want


def test_bf16_cmi_published_by_jax_host_resumes_here(tmp_path):
    """In bf16 the caches cross as int16 views and are restored bit for
    bit; the port's next logits from them are within the bf16 tolerance of
    the JAX package's, and the port finishes with zero re-prefill."""
    jeng = jax_make_engine(MODEL)
    assert jeng.cfg.dtype == "bfloat16"
    req = {"id": "x1", "prompt": [11, 2, 99, 7, 40, 3], "max_new": 10}
    job, state = _published_by_jax_host(tmp_path, jeng, req)
    host, got = _resume_here(tmp_path, jeng, req, job, state)
    eng = host.engine
    caches = {"g0": {k: t.clone() for k, t in host.active["x1"]["caches"]["g0"].items()}}
    tok, pos = int(state["tok"]), int(state["pos"])
    jl, _ = jeng.model.decode(jeng.params, state["caches"], jnp.asarray([[tok]], jnp.int32),
                              jnp.int32(pos))
    tl, _ = eng.model.decode(eng.params, caches, torch.tensor([[tok]]), pos)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BF16_LOGITS_TOL)
    got = {"x1": got}
    _run_host(host, got)
    assert host.counters["prefills"] == 0 and host.counters["resumes"] == 1
    assert len(got["x1"]) == req["max_new"] and got["x1"][:5] == jax_transcript(state)


def test_fabric_half_raises(tmp_path):
    """The migration services raise, and leave the request where it was,
    when there is no request, no NodeServer or no destination; the fleet
    itself is in test_torch_serve_fleet.py."""
    node = NBS(tmp_path / "store").add_node("s0", device="cpu")
    host = ServeHost(make_engine(TOY))
    host.register(node)
    assert {svc for svc in node.services if svc.startswith("svc/serve_")} == {
        f"svc/serve_{s}" for s in ("admit", "step", "status", "publish", "warm", "handoff",
                                   "adopt", "resume", "drop", "drain")}
    nowhere = ("unix", str(tmp_path / "nobody.sock"))
    for call in (lambda: host.warm("r", nowhere), lambda: host.handoff("r", nowhere)):
        with pytest.raises(KeyError, match="no active request"):
            call()
    with pytest.raises(RuntimeError, match="NodeServer"):
        host.adopt("r", "tok")
    host.admit("r", [1, 2, 3], 4)
    with pytest.raises(StreamHopError):
        host.drain(nowhere)
    assert "r" in host.active and host.counters["migrations_out"] == 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_smoke_on_cpu_is_deterministic(capsys):
    argv = ["--device", "cpu", "--arch", "qwen3-1.7b", "--smoke", "--gen", "6",
            "--prompt-len", "12", "--batch", "3"]
    a, b = launch_serve.main(argv), launch_serve.main(argv)
    assert a["transcripts"] == b["transcripts"]
    assert a["decoded"] == 3 * 5 and a["prefill_tok_s"] > 0 and a["decode_tok_s"] > 0
    reqs = launch_serve.build_requests(256, batch=3, prompt_len=12, gen=6, seed=0)
    assert a["transcripts"] == run_reference(make_engine(MODEL, device="cpu"), reqs)
    assert "r002:" in capsys.readouterr().out


def test_cli_refuses_what_it_cannot_run():
    if torch.cuda.is_available():
        return  # the default device is there: nothing to refuse
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--arch", "qwen3-1.7b", "--smoke"])
    # a serving worker asked for the card where there is none exits non-zero
    with pytest.raises(RuntimeError, match="died during startup"):
        launch_serve.main(["--workers", "1", "--gen", "2", "--batch", "1"])
