"""The Figure-7 job loop in torch worker processes (``--device cpu``).

Ported from ``tests/test_fabric.py``: a worker SIGKILLed mid-job is replaced
and the job resumes from its last committed CMI to a product bit-identical
to an uninterrupted run; the supervisor replaces a worker killed from
outside; a lease held by a SIGKILLed worker expires on its own and a rival
finishes the job bit-identically; a worker that ignores SIGTERM is
SIGKILLed when the supervisor's shutdown window runs out. The demo job is
float64 tensors on the worker's device.
"""

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.chaos import faults
from repro_torch.core.cmi import restore_cmi
from repro_torch.core.jobstore import STATUS_CKPT, STATUS_FINISHED, JobStore
from repro_torch.core.preemption import SpotSchedule
from repro_torch.fabric import worker as fw
from repro_torch.fabric.proxy import FabricClient
from repro_torch.fabric.supervisor import FabricSupervisor
from repro_torch.fabric.worker import EXIT_FINISHED

PER_TEST_TIMEOUT_S = int(os.environ.get("NAVP_TEST_TIMEOUT", "180"))
JOB_INPUT = {"seed": 3, "n": 1024, "steps": 40, "publish_every": 5}


@pytest.fixture(autouse=True)
def _alarm_guard():
    """Per-test wall-clock guard: process-spawning tests must never hang."""

    def on_alarm(signum, frame):
        raise TimeoutError(f"fabric test exceeded {PER_TEST_TIMEOUT_S}s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(PER_TEST_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture
def fab(tmp_path):
    jroot = tmp_path / "jobs"
    sup = FabricSupervisor(str(tmp_path / "s3"), str(jroot), device="cpu")
    try:
        yield sup, JobStore(jroot)
    finally:
        sup.shutdown()


def _product(js: JobStore, job_id: str) -> tuple[bytes, int]:
    job = js.read_job(job_id)
    assert job.status == STATUS_FINISHED and job.product
    state, _ = restore_cmi(js.cmi_root(job_id), job.product, device="cpu")
    assert state["w"].dtype == torch.float64
    return state["w"].numpy().tobytes(), int(state["t"])


def _in_process_product() -> tuple[bytes, int]:
    """The same job run here, step by step, on the CPU."""
    state = fw.init_state(JOB_INPUT, "cpu")
    while state["t"] < JOB_INPUT["steps"]:
        state = fw.job_step(state)
    return state["w"].numpy().tobytes(), state["t"]


def _run_clean(sup: FabricSupervisor, js: JobStore) -> tuple[bytes, int]:
    job = js.create_job(JOB_INPUT)
    out = sup.run_job(job.job_id, steps=40, publish_every=5, step_ms=1, timeout_s=120)
    assert out["incarnations"] == 1 and out["reclaims"] == 0
    return _product(js, job.job_id)


def test_sigkill_mid_job_resumes_bit_identical(fab):
    """SIGKILL (no notice) mid-job; a fresh process resumes from the last
    published CMI; the product is bit-identical to an uninterrupted run and
    to the same steps taken in this process."""
    sup, js = fab
    clean = _run_clean(sup, js)
    assert clean == _in_process_product()
    job = js.create_job(JOB_INPUT)
    sched = SpotSchedule(preempt_steps=(10,), max_preemptions=1)
    out = sup.run_job(job.job_id, schedule=sched, notice=False,
                      steps=40, publish_every=5, step_ms=20, timeout_s=150)
    assert out["reclaims"] == 1 and out["incarnations"] == 2
    assert _product(js, job.job_id) == clean


def test_supervisor_respawns_on_crash(fab):
    """A worker killed from outside the supervisor's reclaim path is
    detected and replaced; the job still finishes bit-identically."""
    sup, js = fab
    job = js.create_job(JOB_INPUT)

    def assassin():
        js.wait_for_status(job.job_id, STATUS_CKPT, timeout_s=60)
        if sup.workers:
            h = next(iter(sup.workers.values()))
            try:
                os.kill(h.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass

    t = threading.Thread(target=assassin, daemon=True)
    t.start()
    out = sup.run_job(job.job_id, steps=40, publish_every=5, step_ms=20, timeout_s=150)
    t.join(timeout=10)
    assert out["incarnations"] >= 2
    assert _product(js, job.job_id) == _in_process_product()


def test_shutdown_escalates_on_sigterm_ignorers(fab, monkeypatch):
    """shutdown() SIGTERMs the fleet, waits a bounded window, then SIGKILLs
    the stragglers: a worker that ignores SIGTERM (REPRO_CHAOS_IGNORE_SIGTERM)
    cannot wedge teardown, and a polite one exits cleanly."""
    sup, js = fab
    sup.spawn("polite", serve_only=True)
    monkeypatch.setenv("REPRO_CHAOS_IGNORE_SIGTERM", "1")
    sup.spawn("hung", serve_only=True)
    procs = {n: h.proc for n, h in sup.workers.items()}
    t0 = time.monotonic()
    sup.shutdown(wait_s=1.5)
    assert time.monotonic() - t0 < 60.0
    assert sup.workers == {}
    for proc in procs.values():
        assert proc.poll() is not None  # everyone is dead and reaped
    assert procs["hung"].returncode == -signal.SIGKILL


def test_a_worker_serves_only_once_its_setup_has_registered(tmp_path, monkeypatch):
    """run_node_process binds the address first but answers no call until
    ``setup`` is done: a caller that connects while a worker still builds
    (a model on the card takes seconds) reaches the worker's own services,
    not a node without them."""
    monkeypatch.setattr(faults, "_role", faults._role)  # set_role is undone
    monkeypatch.setattr(faults, "_node", faults._node)
    sock = str(tmp_path / "w.sock")
    args = fw.build_parser().parse_args(
        ["--name", "W", "--store", str(tmp_path / "s3"), "--socket", sock, "--device", "cpu"])
    connected, answers = threading.Event(), []

    def caller():
        with FabricClient(("unix", sock)) as client:
            connected.set()
            answers.append(client.request("svc/probe"))

    def setup(proc):
        threading.Thread(target=caller, daemon=True).start()
        assert connected.wait(30)  # the caller is in before the service is
        time.sleep(0.3)
        proc.node.register("svc/probe", lambda: {"node": proc.name})

    def body(proc):
        deadline = time.monotonic() + 30
        while not answers and time.monotonic() < deadline:
            time.sleep(0.01)
        return EXIT_FINISHED

    old_sigterm = signal.getsignal(signal.SIGTERM)
    try:
        assert fw.run_node_process(args, body, setup=setup) == EXIT_FINISHED
    finally:
        signal.signal(signal.SIGTERM, old_sigterm)
    assert answers == [{"node": "W"}]
    assert not os.path.exists(sock)  # the server stopped after the body


def test_lease_expiry_steal_after_holder_sigkill(fab):
    """The holder is SIGKILLed between heartbeats; its lease expires on its
    own, a polite rival claims it, and a rescuer drives the job to the
    bit-identical product."""
    from repro_torch.chaos import faults

    sup, js = fab
    job = js.create_job(JOB_INPUT)
    lease_s = 3.0
    with faults.arm({"point": "lease.before_renew", "action": "sigkill", "role": "worker"}):
        h = sup.spawn("holder", job_id=job.job_id, steps=40, publish_every=5,
                      step_ms=100, lease_s=lease_s, wait=False)
    assert h.wait(timeout=60) == -signal.SIGKILL
    sup.workers.pop("holder", None)

    j = js.read_job(job.job_id)
    assert j.lease_owner == "holder" and j.leased()  # dead but still leased
    assert js.svc_get_job(job.job_id, worker="rival", steal=False) is None
    deadline = time.monotonic() + lease_s + 10
    while js.read_job(job.job_id).leased():
        assert time.monotonic() < deadline, "lease never expired"
        time.sleep(0.1)
    stolen = js.svc_get_job(job.job_id, worker="rival", lease_s=60.0, steal=False)
    assert stolen is not None and stolen.lease_owner == "rival"
    js.release(job.job_id)

    sup.spawn("rescuer", job_id=job.job_id, steps=40, publish_every=5, step_ms=1, wait=False)
    assert sup.workers["rescuer"].wait(timeout=60) == EXIT_FINISHED
    assert _product(js, job.job_id) == _in_process_product()


def test_demo_job_matches_the_reference_job_within_float64_rounding():
    """The torch demo job follows the JAX package's numpy one step for step
    (``torch.sin`` and ``np.sin`` may differ in the last bit)."""
    from repro.fabric import worker as jfw

    ref = jfw.init_state(JOB_INPUT)
    mine = fw.init_state(JOB_INPUT, "cpu")
    assert mine["w"].numpy().tobytes() == ref["w"].tobytes()
    for _ in range(JOB_INPUT["steps"]):
        ref, mine = jfw.job_step(ref), fw.job_step(mine)
    assert mine["t"] == ref["t"] == JOB_INPUT["steps"]
    np.testing.assert_allclose(mine["w"].numpy(), ref["w"], rtol=1e-15, atol=0)


def test_agent_respawns_a_torch_worker_and_the_registry_re_resolves():
    """The agent smoke over TCP with a torch worker: the agent's child is
    SIGKILLed through the pid the registry recorded, respawned at a new port
    under a new generation, and re-resolved by name."""
    from repro_torch.fabric import agent

    assert agent.smoke("cpu") == 0
