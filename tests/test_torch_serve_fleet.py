"""The port's serving fleet on the CPU, against the JAX package's.

Ported from the fleet half of ``tests/test_serve.py``: a request's
transcript is a pure function of (engine seed, prompt, max_new), so every
way a request travels between torch serving hosts — a pre-copy migration
over the streamed delta hop (only the rows decoded since the warm baseline
ship), the store fallback when the stream is armed to die, a bulk drain, a
SIGTERM-notice publish, a SIGKILL (or a SIGTERM ignored until the
supervisor escalates to one) and a resume from the last published CMI
— must give the transcript the JAX package's ``run_reference`` gives. The
hosts run in this process behind real NodeServers (``device="cpu"``), or as
``python -m repro_torch.serve.worker --device cpu`` processes.

Two cases go beyond the reference's: a smoke-width model engine, whose
decode writes the caches in place after the warm copy left, still hands the
destination its caches bit for bit; and a request migrates from a JAX
package host to a torch one and back on one wire.

Process-spawning tests use the same SIGALRM guard as tests/test_torch_fabric.py.
"""

import os
import signal
import time

import numpy as np
import pytest
import torch

from repro.core import DHP as JDHP, NBS as JNBS, JobStore as JJobStore
from repro.fabric.server import NodeServer as JNodeServer
from repro.serve.engine import make_engine as jax_make_engine
from repro.serve.engine import run_reference as jax_run_reference
from repro.serve.worker import ServeHost as JServeHost
from repro_torch.chaos import faults
from repro_torch.core import DHP, NBS
from repro_torch.core.cmi import restore_cmi
from repro_torch.core.jobstore import STATUS_FINISHED, JobStore
from repro_torch.fabric.proxy import wait_ready
from repro_torch.fabric.server import NodeServer
from repro_torch.fabric.supervisor import FabricSupervisor
from repro_torch.fabric.worker import EXIT_PREEMPTED
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import ServeHost, ServeRouter, make_engine, run_reference
from repro_torch.serve.scenarios import spawn_serve_worker
from repro_torch.utils import flatten_with_paths

PER_TEST_TIMEOUT_S = int(os.environ.get("NAVP_TEST_TIMEOUT", "180"))

SPEC = "toy:d=64,vocab=256,seed=3"
MODEL = "model:qwen3-1.7b:smoke:seed=0"
REQS = [
    {"id": f"q{i}", "prompt": [5 + 3 * i, 40, 17 + i, 8], "max_new": 12}
    for i in range(4)
]


@pytest.fixture(autouse=True)
def _alarm_guard():
    def on_alarm(signum, frame):
        raise TimeoutError(f"serve fleet test exceeded {PER_TEST_TIMEOUT_S}s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(PER_TEST_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _expected(reqs, spec=SPEC):
    """The oracle: the JAX package's run_reference, which the port's equals."""
    want = jax_run_reference(jax_make_engine(spec), reqs)
    assert run_reference(make_engine(spec, device="cpu"), reqs) == want
    return want


# ---------------------------------------------------------------------------
# in-process fleet (real NodeServers + wire, no spawned processes)
# ---------------------------------------------------------------------------


def _mk_fleet(tmp_path, names=("s0", "s1"), *, spec=SPEC, chunk_bytes=4096,
              publish_every=3):
    nbs = NBS(tmp_path / "store")
    js = JobStore(tmp_path / "jobs")
    engine = make_engine(spec, device="cpu")  # stateless: the hosts share it
    hosts, servers = {}, {}
    for name in names:
        node = nbs.add_node(name, device="cpu")
        srv = NodeServer(nbs, name, ("unix", str(tmp_path / f"{name}.sock")),
                         jobstore=js).start()
        host = ServeHost(engine, node_name=name,
                         dhp=DHP(nbs, name, js, chunk_bytes=chunk_bytes),
                         server=srv, publish_every=publish_every,
                         chunk_bytes=chunk_bytes)
        host.register(node)
        hosts[name], servers[name] = host, srv
    router = ServeRouter(jobstore=js)
    for name, srv in servers.items():
        router.add_worker(name, srv.address)
    return js, hosts, servers, router


def _teardown(servers, router):
    router.close()
    for srv in servers.values():
        srv.stop()


def test_migration_ships_only_rows_since_warm(tmp_path):
    """The append-only KV delta property, on the wire.

    d=64 float64 rows are 512 B; chunk_bytes=4096 packs 8 rows per chunk.
    After the warm baseline, 4 decode steps land in at most 2 kv chunks
    (plus the chunk carrying ``out``) — the handoff must ref everything
    else, as the JAX package's tests/test_serve.py asserts for its own.
    """
    js, hosts, servers, router = _mk_fleet(tmp_path)
    try:
        rid = router.admit([7] * 8, 25, req_id="big", worker="s0")
        warm = router.warm(rid, "s1")
        assert warm["data_chunks"] + warm["ref_chunks"] == warm["chunks"]
        assert warm["data_chunks"] >= 3
        total_chunks = warm["chunks"]
        assert total_chunks >= 4  # the kv cache alone spans multiple chunks
        for _ in range(4):
            router.step()
        res = router.handoff(rid, "s1")
        assert res["warm"] is True
        assert res["chunks"] == total_chunks  # preallocated state: no growth
        assert res["data_chunks"] + res["ref_chunks"] == res["chunks"]
        # only the chunks the 4 new rows (+ out) landed in actually travel
        assert 1 <= res["data_chunks"] <= 3
        assert res["data_chunks"] < res["chunks"] / 2
        assert 0 < res["sent_bytes"] < warm["sent_bytes"]
        router.run_to_completion()
        expected = _expected([{"id": "big", "prompt": [7] * 8, "max_new": 25}])
        assert router.transcript("big") == expected["big"]
        assert hosts["s1"].counters["prefills"] == 0  # zero re-prefill
        assert hosts["s1"].counters["migrations_in"] == 1
        assert hosts["s0"].counters["migrations_out"] == 1
        assert servers["s1"].resident == {}  # the warm copy was retired
    finally:
        _teardown(servers, router)


def test_concurrent_warm_baselines_do_not_clobber(tmp_path):
    """Two requests pre-copied to the SAME destination keep separate
    baselines (serve keys them per (request, dest))."""
    js, hosts, servers, router = _mk_fleet(tmp_path, chunk_bytes=2048)
    try:
        a = router.admit([3] * 8, 20, req_id="a", worker="s0")
        b = router.admit([9] * 8, 20, req_id="b", worker="s0")
        router.warm(a, "s1")
        router.warm(b, "s1")
        for _ in range(3):
            router.step()
        ra = router.handoff(a, "s1")
        rb = router.handoff(b, "s1")
        for r in (ra, rb):
            assert r["warm"] is True
            assert r["ref_chunks"] >= 1  # each delta'd against ITS baseline
        router.run_to_completion()
        expected = _expected([{"id": "a", "prompt": [3] * 8, "max_new": 20},
                              {"id": "b", "prompt": [9] * 8, "max_new": 20}])
        assert router.transcript("a") == expected["a"]
        assert router.transcript("b") == expected["b"]
    finally:
        _teardown(servers, router)


def test_stream_failure_falls_back_to_store(tmp_path):
    """Both live-migration legs armed to die -> publish + resume through
    the CAS store, transcripts unharmed, event records the fallback."""
    js, hosts, servers, router = _mk_fleet(tmp_path)
    try:
        expected = _expected(REQS)
        for req in REQS:
            router.admit(req["prompt"], req["max_new"], req_id=req["id"])
            router.step()
        victim = next(r for r in sorted(router.pending())
                      if router.assignment[r] == "s0")
        with faults.arm({"point": "serve.migrate.mid_stream",
                         "action": "kill_conn", "times": 2}):
            event = router.migrate(victim, "s1")
        assert event["mode"] == "store"
        assert router.assignment[victim] == "s1"
        router.run_to_completion()
        for req in REQS:
            assert router.transcript(req["id"]) == expected[req["id"]]
        # the source forgot the request (no double-decode after fallback)
        assert victim not in hosts["s0"].active
        assert hosts["s1"].counters["resumes"] == 1
        assert hosts["s1"].counters["migrations_in"] == 0
    finally:
        _teardown(servers, router)


def test_finished_request_publishes_product(tmp_path):
    js, hosts, servers, router = _mk_fleet(tmp_path, names=("s0",))
    try:
        rid = router.admit([2, 4, 6], 5, req_id="p0")
        job_id = router.jobs[rid]
        router.run_to_completion()
        job = js.read_job(job_id)
        assert job.status == STATUS_FINISHED and job.product
        product, _ = restore_cmi(js.cmi_root(job_id), job.product, device="cpu")
        assert [int(t) for t in product["tokens"]] == router.transcript(rid)
        assert router.transcript(rid) == _expected(
            [{"id": "p0", "prompt": [2, 4, 6], "max_new": 5}])["p0"]
    finally:
        _teardown(servers, router)


def test_bulk_drain_moves_every_request_live(tmp_path):
    """The upgrade path: svc/serve_drain hands every active request of s0
    to s1 over the stream, with no prefill on s1 and the oracle's
    transcripts."""
    js, hosts, servers, router = _mk_fleet(tmp_path)
    try:
        expected = _expected(REQS)
        for req in REQS:
            router.admit(req["prompt"], req["max_new"], req_id=req["id"])
        for _ in range(2):
            router.step()
        on_s0 = sorted(r for r in router.pending() if router.assignment[r] == "s0")
        moved = router.drain("s0", "s1")
        assert moved == on_s0 and router.events[-1]["mode"] == "bulk"
        assert hosts["s0"].active == {}
        assert hosts["s1"].counters["migrations_in"] == len(on_s0)
        assert hosts["s1"].counters["prefills"] == len(REQS) - len(on_s0)
        router.run_to_completion()
        for req in REQS:
            assert router.transcript(req["id"]) == expected[req["id"]]
    finally:
        _teardown(servers, router)


def test_model_cache_written_in_place_after_warm_arrives_bitwise(tmp_path):
    """Decode writes the model caches in place, so the warm copy's rows go
    stale under the source's feet. The handoff negotiates on chunk-hash
    grids, not device change hints, so the destination still adopts the
    source's caches bit for bit — and finishes with the oracle's
    transcript at zero re-prefill."""
    req = {"id": "m0", "prompt": [3, 1, 4, 1, 5, 9, 2, 6], "max_new": 10}
    js, hosts, servers, router = _mk_fleet(tmp_path, spec=MODEL, chunk_bytes=2048)
    try:
        assert hosts["s0"].engine.cfg.dtype == "bfloat16"
        router.admit(req["prompt"], req["max_new"], req_id="m0", worker="s0")
        warm = router.warm("m0", "s1")
        for _ in range(3):
            router.step()
        src = hosts["s0"].active["m0"]
        before, _ = flatten_with_paths({k: src[k] for k in ("caches", "out")})
        before = {k: (v.clone() if isinstance(v, torch.Tensor) else np.array(v))
                  for k, v in before.items()}
        res = router.handoff("m0", "s1")
        assert res["warm"] is True and res["data_chunks"] >= 1
        assert res["data_chunks"] < warm["data_chunks"]  # the prompt's rows ref'd
        got = hosts["s1"].active["m0"]
        after, _ = flatten_with_paths({k: got[k] for k in ("caches", "out")})
        assert set(after) == set(before)
        for k, v in before.items():
            w = after[k]
            if isinstance(v, torch.Tensor):
                assert w.dtype == v.dtype and torch.equal(w, v), k
            else:
                assert isinstance(w, np.ndarray) and np.array_equal(w, v), k
        assert int(got["pos"]) == int(src["pos"]) and int(got["done"]) == int(src["done"])
        router.run_to_completion()
        want = run_reference(make_engine(MODEL, device="cpu"), [req])
        assert router.transcript("m0") == want["m0"]
        assert hosts["s1"].counters["prefills"] == 0
    finally:
        _teardown(servers, router)


def test_request_crosses_from_jax_host_to_torch_host_and_back(tmp_path):
    """One wire, both packages: a request admitted on a JAX package host is
    warmed and handed off to a torch host, decodes there, and is warmed and
    handed back; both moves stream, neither side prefills it again, and
    the transcript is the oracle's."""
    js = JobStore(tmp_path / "jobs")
    jnbs, tnbs = JNBS(tmp_path / "jstore"), NBS(tmp_path / "tstore")
    jnode = jnbs.add_node("j0", mesh=None)
    jsrv = JNodeServer(jnbs, "j0", ("unix", str(tmp_path / "j0.sock")),
                       jobstore=JJobStore(tmp_path / "jobs")).start()
    jhost = JServeHost(jax_make_engine(SPEC), node_name="j0", server=jsrv,
                       dhp=JDHP(jnbs, "j0", JJobStore(tmp_path / "jobs"), chunk_bytes=4096),
                       publish_every=3, chunk_bytes=4096)
    jhost.register(jnode)
    tnode = tnbs.add_node("t0", device="cpu")
    tsrv = NodeServer(tnbs, "t0", ("unix", str(tmp_path / "t0.sock")), jobstore=js).start()
    thost = ServeHost(make_engine(SPEC, device="cpu"), node_name="t0", server=tsrv,
                      dhp=DHP(tnbs, "t0", js, chunk_bytes=4096),
                      publish_every=3, chunk_bytes=4096)
    thost.register(tnode)
    router = ServeRouter(jobstore=js)
    router.add_worker("j0", jsrv.address)
    router.add_worker("t0", tsrv.address)
    try:
        req = {"id": "x0", "prompt": [7, 3, 9, 1, 4, 4, 2, 8], "max_new": 24}
        router.admit(req["prompt"], req["max_new"], req_id="x0", worker="j0")
        for _ in range(3):
            router.step()
        there = router.migrate("x0", "t0")
        for _ in range(5):
            router.step()
        back = router.migrate("x0", "j0")
        for event in (there, back):
            assert event["mode"] == "stream" and event["warm"] is True, event
        assert thost.counters["migrations_in"] == thost.counters["migrations_out"] == 1
        assert jhost.counters["migrations_in"] == 1 and jhost.counters["prefills"] == 1
        assert thost.counters["prefills"] == 0
        router.run_to_completion()
        assert router.transcript("x0") == _expected([req])["x0"]
        assert js.read_job(router.jobs["x0"]).status == STATUS_FINISHED
    finally:
        router.close()
        jsrv.stop()
        tsrv.stop()


# ---------------------------------------------------------------------------
# spawned fleets: the headline + the notice path
# ---------------------------------------------------------------------------


@pytest.fixture
def fleet(tmp_path):
    sup = FabricSupervisor(str(tmp_path / "s3"), str(tmp_path / "jobs"), device="cpu")
    try:
        yield sup, JobStore(tmp_path / "jobs")
    finally:
        sup.shutdown()


def _spawn(sup, router, names, *, publish_every=3):
    for name in names:  # the workers start together
        spawn_serve_worker(sup, name, engine_spec=SPEC, publish_every=publish_every,
                           chunk_bytes=4096, wait=False)
    for name in names:
        wait_ready(sup.workers[name].address, timeout=90)
        router.add_worker(name, sup.workers[name].address)


def test_headline_migrate_then_sigkill_resume(fleet):
    """A 2-worker continuous-batching run where one in-flight request
    live-migrates mid-generation via a streamed delta hop (zero re-prefill,
    asserted on the destination's counters) and a SIGKILLed worker's
    requests resume from the last published CMI — all transcripts
    bit-identical to the unperturbed single-engine run."""
    sup, js = fleet
    router = ServeRouter(jobstore=js)
    expected = _expected(REQS)
    try:
        _spawn(sup, router, ("s0", "s1"))
        for req in REQS:  # staggered joins
            router.admit(req["prompt"], req["max_new"], req_id=req["id"])
            router.step()

        victim = next(r for r in sorted(router.pending())
                      if router.assignment[r] == "s0")
        router.warm(victim, "s1")
        router.step()  # the warm copy goes stale by exactly this row
        event = router.migrate(victim, "s1", warm=False)
        assert event["mode"] == "stream"
        assert event["warm"] is True
        assert event["ref_chunks"] >= 1  # the delta actually delta'd
        assert event["data_chunks"] + event["ref_chunks"] == event["chunks"]
        status = router.call("s1", "svc/serve_status")
        assert status["counters"]["migrations_in"] == 1
        # zero re-prefill: s1 prefilled only the requests admitted TO it
        admitted_on_s1 = sum(
            1 for e in router.events
            if e["kind"] == "admit" and e["worker"] == "s1")
        assert status["counters"]["prefills"] == admitted_on_s1

        for _ in range(2):
            router.step()
        rc = sup.reclaim("s0", notice=False)  # SIGKILL: no flush, no notice
        assert rc == -signal.SIGKILL
        resumed = router.recover("s0", "s1")
        assert resumed  # something was actually stranded and came back
        router.run_to_completion()
        for req in REQS:
            assert router.transcript(req["id"]) == expected[req["id"]]
        for job_id in router.jobs.values():
            assert js.read_job(job_id).status == STATUS_FINISHED
        # the toy engine launches no kernel in the workers
        assert router.call("s1", "svc/kernel_launches")["flash_attention"] == 0
    finally:
        router.close()


def test_sigterm_notice_publishes_in_flight(fleet):
    """The 2-minute-notice path: SIGTERM -> publish-all -> EXIT_PREEMPTED;
    a resume on a fresh worker starts from the notice-time step."""
    sup, js = fleet
    router = ServeRouter(jobstore=js)
    expected = _expected(REQS)
    try:
        _spawn(sup, router, ("s0",), publish_every=100)  # cadence never fires
        for req in REQS:
            router.admit(req["prompt"], req["max_new"], req_id=req["id"])
        for _ in range(4):
            router.step()
        done_at_notice = {
            rid: len(tr) for rid, tr in router.transcripts.items()}
        rc = sup.reclaim("s0", notice=True, wait_s=30)
        assert rc == EXIT_PREEMPTED

        _spawn(sup, router, ("s1",))
        resumed = router.recover("s0", "s1")
        assert set(resumed) == {r["id"] for r in REQS}
        for e in router.events:
            if e["kind"] == "resume":
                assert e["done"] == done_at_notice[e["req"]]
        router.run_to_completion()
        for req in REQS:
            assert router.transcript(req["id"]) == expected[req["id"]]
    finally:
        router.close()


def test_reclaim_escalates_on_a_serving_worker_that_ignores_sigterm(fleet, monkeypatch):
    """The notice is a deadline: a serving worker that ignores SIGTERM (a
    hung handler, armed by REPRO_CHAOS_IGNORE_SIGTERM) is SIGKILLed once
    ``wait_s`` runs out, so no notice publish happens; its requests resume
    on a fresh worker from their admit-time CMIs to the reference
    transcripts."""
    sup, js = fleet
    router = ServeRouter(jobstore=js)
    expected = _expected(REQS[:2])
    try:
        monkeypatch.setenv("REPRO_CHAOS_IGNORE_SIGTERM", "1")
        _spawn(sup, router, ("s0",), publish_every=100)  # cadence never fires
        monkeypatch.delenv("REPRO_CHAOS_IGNORE_SIGTERM")
        for req in REQS[:2]:
            router.admit(req["prompt"], req["max_new"], req_id=req["id"])
        for _ in range(3):
            router.step()
        t0 = time.monotonic()
        rc = sup.reclaim("s0", notice=True, wait_s=1.5)
        assert rc == -signal.SIGKILL  # escalation, not EXIT_PREEMPTED
        assert 1.0 < time.monotonic() - t0 < 30.0
        assert "s0" not in sup.workers

        _spawn(sup, router, ("s1",))
        resumed = router.recover("s0", "s1")
        assert set(resumed) == {r["id"] for r in REQS[:2]}
        # nothing was published at the notice: each resumes from its admit
        assert all(e["done"] == 1 for e in router.events if e["kind"] == "resume")
        router.run_to_completion()
        for req in REQS[:2]:
            assert router.transcript(req["id"]) == expected[req["id"]]
    finally:
        router.close()


# ---------------------------------------------------------------------------
# launch CLI
# ---------------------------------------------------------------------------


def test_launch_cli_local_deterministic(capsys):
    argv = ["--device", "cpu", "--gen", "6", "--batch", "3", "--prompt-len", "5"]
    m1 = launch_serve.main(argv)
    m2 = launch_serve.main(argv)
    assert m1["transcripts"] == m2["transcripts"]
    assert m1["prefill_tok_s"] > 0 and m1["decode_tok_s"] > 0
    assert "r000:" in capsys.readouterr().out
    reqs = launch_serve.build_requests(512, batch=3, prompt_len=5, gen=6, seed=0)
    assert m1["transcripts"] == _expected(reqs, spec="toy:seed=0")


def test_launch_cli_routed_matches_local():
    argv = ["--device", "cpu", "--gen", "6", "--batch", "3", "--prompt-len", "5"]
    local = launch_serve.main(argv)
    routed = launch_serve.main(argv + ["--workers", "2"])
    assert routed["transcripts"] == local["transcripts"]
    assert routed["mode"] == "routed:2xunix"
    assert 0 < routed["ttft_p50_s"] <= routed["ttft_max_s"]
