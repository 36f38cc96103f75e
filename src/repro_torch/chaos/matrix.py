"""Chaos matrix: every (protocol, state) cell gets a fault and must recover.

Port of the JAX package's ``repro/chaos/matrix.py``, with the same cells,
against torch worker processes (``repro_torch.fabric.worker``,
``repro_torch.serve.worker``) on ``--device`` (default: the CUDA card;
``cpu`` on request). The tour's input and its uninterrupted product live
in this process on the same device as the workers, so "bit-identical"
compares the same arithmetic.

``python -m repro_torch.chaos.matrix`` enumerates the fabric's injectable protocol
states (see ``docs/fabric.md`` § "Chaos matrix"), arms one fault per cell via
:mod:`repro_torch.chaos.faults`, runs a real multi-process scenario with the fault
landing exactly at that state, and asserts the paper's survivability
invariants after recovery:

* the final product is **bit-identical** to an uninterrupted run,
* the store's hop namespace is empty (no leaked transit CMIs),
* no torn CMI staging directories survive,
* no job is left holding a stranded lease,
* the content-addressed object store passes ``fsck`` (no torn objects, no
  dangling manifest refs — orphans are the only allowed kill residue).

Two scenarios carry the cells:

``tour``
    a 3-worker remote itinerary (read -> compute -> write across B/C/D,
    streamed hops + relays + streamed fetch-back). Recovery is whatever the
    fabric already does — transparent stream->store fallback, reconnect-
    resend, per-hop relay fallback — plus, for faults that kill a worker
    process, a respawn-in-place at the pinned socket and a retry of the tour
    from the original input (the driver still holds it; the computation is
    deterministic, so the retried product must match bit-for-bit).

``job``
    a publish/resume job on one worker. The armed fault kills the worker
    mid-protocol (or fails the publish); replacements are spawned *without*
    the plan (fault counters are per-process, so a respawned worker would
    re-fire the fault) and must drive the job to "finished" from the last
    committed CMI.

``fleet``
    a registry + per-host agent + agent-spawned worker, all over TCP (the
    registry/agent layer has no unix mode — it exists to cross hosts).
    Faults strike the registry's resolve/heartbeat paths or the agent's
    spawn/respawn service; recovery is the SUSPECT -> DEAD detection loop,
    the agent's backoff-retried respawn at a fresh port, and registry
    re-resolution — the node must end ALIVE under a bumped generation (or,
    for pure heartbeat gaps, the SAME generation with no respawn at all).

``serve``
    an elastic serving fleet: two serving workers (``repro_torch.serve.worker``)
    under a router running continuous batching. Faults strike the serve
    protocol states — admission, the live-migration stream, the SIGTERM
    notice path, bulk drain — and recovery is the router's ladder: retry
    admission on another worker, fall back from the streamed delta handoff
    to publish + resume through the CAS store, resume a SIGKILLed worker's
    requests from their last published CMI on a survivor. The invariant is
    the subsystem's own: every transcript bit-identical to an unperturbed
    single-engine run.

The ``tour``, ``job``, and ``serve`` scenarios run on either transport
(``--transport unix|tcp|both``); ``both`` proves every recovery invariant
on the wire path real fleets use, with respawn-in-place happening at
pinned TCP ports instead of pinned socket paths.

Exit status is non-zero if any cell fails — CI runs ``--smoke`` (one cell
per protocol family); the full matrix is the local soak.
"""

from __future__ import annotations

import argparse
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch.chaos import faults
from repro_torch.core.cmi import restore_cmi
from repro_torch.core.dhp import DHP
from repro_torch.core.jobstore import STATUS_FINISHED, JobStore
from repro_torch.core.nbs import NBS
from repro_torch.fabric.supervisor import FabricSupervisor

JOB_INPUT = {"seed": 3, "n": 1024, "steps": 40, "publish_every": 5}

# ---------------------------------------------------------------------------
# the matrix
# ---------------------------------------------------------------------------
# Every labeled protocol state appears at least once. "role" keeps sigkill
# strikes inside worker processes — the driver (this process) must survive
# to judge the outcome.

CELLS: list[dict] = [
    # -- hop (store-mediated) ---------------------------------------------
    {"id": "hop.after_save:error", "scenario": "tour",
     "spec": {"point": "hop.after_save", "action": "error", "role": "driver"}},
    {"id": "hop.before_restore:error", "scenario": "tour",
     "spec": {"point": "hop.before_restore", "action": "error", "role": "worker"}},
    {"id": "hop.before_restore:sigkill", "scenario": "tour",
     "spec": {"point": "hop.before_restore", "action": "sigkill", "role": "worker"}},
    {"id": "hop.before_receipt:kill_conn", "scenario": "tour",
     "spec": {"point": "hop.before_receipt", "action": "kill_conn", "role": "worker"}},
    # -- hop_stream (streamed hop into a worker) --------------------------
    {"id": "hop_stream.accept:kill_conn", "scenario": "tour",
     "spec": {"point": "hop_stream.accept", "action": "kill_conn", "role": "worker"}},
    {"id": "hop_stream.accept:sigkill", "scenario": "tour",
     "spec": {"point": "hop_stream.accept", "action": "sigkill", "role": "worker"}},
    {"id": "hop_stream.mid_stream:kill_conn", "scenario": "tour",
     "spec": {"point": "hop_stream.mid_stream", "action": "kill_conn", "role": "driver"}},
    {"id": "hop_stream.before_receipt:kill_conn", "scenario": "tour",
     "spec": {"point": "hop_stream.before_receipt", "action": "kill_conn",
              "role": "worker"}},
    # -- relay (worker-initiated onward hop) ------------------------------
    {"id": "relay.before_stream:error", "scenario": "tour",
     "spec": {"point": "relay.before_stream", "action": "error", "role": "worker"}},
    {"id": "relay.mid_stream:kill_conn", "scenario": "tour",
     "spec": {"point": "relay.mid_stream", "action": "kill_conn", "role": "worker"}},
    {"id": "relay.after_stream:error", "scenario": "tour",
     "spec": {"point": "relay.after_stream", "action": "error", "role": "worker"}},
    # -- fetch_stream (streamed return leg) -------------------------------
    {"id": "fetch_stream.accept:kill_conn", "scenario": "tour",
     "spec": {"point": "fetch_stream.accept", "action": "kill_conn", "role": "worker"}},
    {"id": "fetch_stream.mid_pump:kill_conn", "scenario": "tour",
     "spec": {"point": "fetch_stream.mid_pump", "action": "kill_conn", "role": "worker"}},
    {"id": "fetch_stream.before_ack:kill_conn", "scenario": "tour",
     "spec": {"point": "fetch_stream.before_ack", "action": "kill_conn",
              "role": "driver"}},
    {"id": "fetch_stream.before_drop:error", "scenario": "tour",
     "spec": {"point": "fetch_stream.before_drop", "action": "error", "role": "worker"}},
    # -- wire / proxy (transport itself) ----------------------------------
    {"id": "wire.send_bulk:garble", "scenario": "tour",
     "spec": {"point": "wire.send_bulk", "action": "garble", "role": "driver"}},
    {"id": "wire.recv_frame:kill_conn", "scenario": "tour",
     "spec": {"point": "wire.recv_frame", "action": "kill_conn", "role": "driver",
              "after": 8}},
    {"id": "proxy.request:kill_conn", "scenario": "tour",
     "spec": {"point": "proxy.request", "action": "kill_conn", "role": "driver",
              "after": 6}},
    # -- publish (the paper's Q4 atomic checkpointing phase) --------------
    {"id": "publish.before_save:sigkill", "scenario": "job",
     "spec": {"point": "publish.before_save", "action": "sigkill", "role": "worker"}},
    {"id": "publish.before_commit:sigkill", "scenario": "job",
     "spec": {"point": "publish.before_commit", "action": "sigkill", "role": "worker"}},
    {"id": "publish.before_commit:error", "scenario": "job",
     "spec": {"point": "publish.before_commit", "action": "error", "role": "worker"}},
    {"id": "publish.before_record:sigkill", "scenario": "job",
     "spec": {"point": "publish.before_record", "action": "sigkill", "role": "worker",
              "after": 1}},
    # -- lease (claim / heartbeat) ----------------------------------------
    {"id": "lease.after_claim:sigkill", "scenario": "job",
     "spec": {"point": "lease.after_claim", "action": "sigkill", "role": "worker"}},
    {"id": "lease.before_renew:sigkill", "scenario": "job", "step_ms": 75,
     "spec": {"point": "lease.before_renew", "action": "sigkill", "role": "worker"}},
    # -- registry (name -> address resolution + liveness) ------------------
    {"id": "registry.resolve:error", "scenario": "fleet",
     "spec": {"point": "registry.resolve", "action": "error", "role": "driver",
              "times": 2}},
    {"id": "registry.heartbeat_gap:delay", "scenario": "fleet", "mode": "gap",
     "spec": {"point": "registry.heartbeat_gap", "action": "delay",
              "delay_s": 1.0, "role": "worker", "times": 2}},
    # -- agent (per-host spawn/respawn service) ----------------------------
    {"id": "agent.spawn:error", "scenario": "fleet",
     "spec": {"point": "agent.spawn", "action": "error", "role": "agent"}},
    {"id": "agent.respawn:error", "scenario": "fleet",
     "spec": {"point": "agent.respawn", "action": "error", "role": "agent"}},
    # -- cas (content-addressed object store, manifest v4) -----------------
    # after=2: the third object write of the run — a kill MID-multi-object
    # publish (some objects linked, one still a tmp file)
    {"id": "cas.publish.pre_link:sigkill", "scenario": "job",
     "spec": {"point": "cas.publish.pre_link", "action": "sigkill", "role": "worker",
              "after": 2}},
    # after=1: the SECOND publish dies with all its objects durable but its
    # manifest never committed — pure orphans, previous publish authoritative
    {"id": "cas.publish.post_objects:sigkill", "scenario": "job",
     "spec": {"point": "cas.publish.post_objects", "action": "sigkill", "role": "worker",
              "after": 1}},
    {"id": "cas.gc.mid_sweep:sigkill", "scenario": "job",
     "spec": {"point": "cas.gc.mid_sweep", "action": "sigkill", "role": "worker"}},
    # -- wire, continued: compressed bulk payloads -------------------------
    # compressible input so frames actually carry a codec marker; the garble
    # lands in the driver's fetch-back decompress and must surface as frame
    # corruption -> clean store fallback, never a codec exception
    {"id": "wire.bulk.decompress:garble", "scenario": "tour", "input": "compressible",
     "spec": {"point": "wire.bulk.decompress", "action": "garble", "role": "driver"}},
    # -- serve (elastic serving fleet) -------------------------------------
    # admission fails on the least-loaded worker; the router must land the
    # request on the next one (exactly-one-admit either way). node-scoped:
    # fault counters are per-process, so an unscoped error would fire once
    # in EVERY worker and exhaust the candidate list
    {"id": "serve.admit:error", "scenario": "serve",
     "spec": {"point": "serve.admit", "action": "error", "role": "worker",
              "node": "s0"}},
    # times=2: the warm stream AND the delta handoff both die mid-frame, so
    # the live path is exhausted and the migration must travel as publish +
    # resume through the store (the router's event records the fallback)
    {"id": "serve.migrate.mid_stream:kill_conn", "scenario": "serve", "mode": "migrate",
     "spec": {"point": "serve.migrate.mid_stream", "action": "kill_conn",
              "role": "worker", "times": 2}},
    # the grace window expires mid-notice: SIGTERM lands, and the final
    # publish-all is cut short by a SIGKILL — the survivors of the admit-time
    # and cadence publishes are the only durable state to resume from
    {"id": "serve.reclaim.notice:sigkill", "scenario": "serve", "mode": "reclaim",
     "spec": {"point": "serve.reclaim.notice", "action": "sigkill",
              "role": "worker", "node": "s0"}},
    # bulk drain refuses; the router finishes the drain per-request (each
    # with its own stream -> store fallback ladder)
    {"id": "serve.drain:error", "scenario": "serve", "mode": "drain",
     "spec": {"point": "serve.drain", "action": "error", "role": "worker",
              "node": "s0"}},
]

def cell_registry() -> list[dict]:
    """The matrix as machine-readable data, one normalized dict per cell.

    This is what the fault-coverage checker (the JAX package's ``python -m
    repro.analysis --coverage``, pointed at this package's tree) cross-checks
    against the AST-extracted ``faults.fire`` sites and the
    ``docs/fabric.md`` state table: every registered site must have at least
    one cell here, and every cell's point must be a registered site.
    """
    from repro_torch.chaos.sites import SITES

    registry = []
    for cell in CELLS:
        point = cell["spec"]["point"]
        if point not in SITES:
            raise ValueError(
                f"matrix cell {cell['id']!r} strikes unregistered point "
                f"{point!r}; add it to repro_torch.chaos.sites.SITES"
            )
        registry.append({
            "id": cell["id"],
            "point": point,
            "family": point.split(".", 1)[0],
            "action": cell["spec"].get("action", "error"),
            "scenario": cell["scenario"],
            "role": cell["spec"].get("role"),
            "smoke": cell["id"] in SMOKE_IDS,
        })
    return registry


# one cell per protocol family — the CI-sized subset
SMOKE_IDS = [
    "hop.after_save:error",
    "hop.before_receipt:kill_conn",
    "hop_stream.mid_stream:kill_conn",
    "relay.mid_stream:kill_conn",
    "fetch_stream.before_ack:kill_conn",
    "wire.send_bulk:garble",
    "publish.before_commit:sigkill",
    "lease.before_renew:sigkill",
    "registry.resolve:error",
    "agent.respawn:error",
    "cas.publish.pre_link:sigkill",
    "serve.migrate.mid_stream:kill_conn",
    "serve.reclaim.notice:sigkill",
]


# ---------------------------------------------------------------------------
# tour scenario
# ---------------------------------------------------------------------------

_TOUR_NODES = ("B", "C", "D")


def _tour_expected(x: torch.Tensor) -> torch.Tensor:
    """The uninterrupted tour, run here on ``x``'s device (the workers')."""
    from repro_torch.fabric import worker as fw

    out = fw.tour_write(fw.tour_compute(fw.tour_read({"x": x.clone()})))
    return out["x"]


def _host_bytes(t: torch.Tensor) -> bytes:
    return t.detach().cpu().numpy().tobytes()


def _spawn_missing(sup: FabricSupervisor, socket_paths: dict[str, str]) -> None:
    """(Re)provision any dead/missing tour worker at its pinned address
    (a socket path on unix, a reserved host:port on tcp)."""
    for name in _TOUR_NODES:
        handle = sup.workers.get(name)
        if handle is not None and handle.alive():
            continue
        sup.workers.pop(name, None)
        sup.spawn(name, serve_only=True, socket_path=socket_paths[name])


def _attempt_tour(sup: FabricSupervisor, store_root: Path, x: torch.Tensor):
    """One full tour over fresh connections; returns (out, nbs)."""
    from repro_torch.core.itinerary import Itinerary, Stage
    from repro_torch.fabric import worker as fw

    nbs = NBS(store_root)
    nbs.add_node("A", device=x.device)
    for name in _TOUR_NODES:
        nbs.add_remote_node(name, sup.workers[name].address)
    dhp = DHP(nbs, "A", chunk_bytes=1 << 14)
    stages = [
        Stage("B", fw.tour_read, "read"),
        Stage("C", fw.tour_compute, "compute"),
        Stage("D", fw.tour_write, "write"),
    ]
    out = Itinerary(dhp).run({"x": x.clone()}, stages)
    return out, nbs


def run_tour_cell(cell: dict, tmp: Path, transport: str = "unix",
                  device: str = "cuda") -> None:
    store_root = tmp / "s3"
    old_comp = None
    if cell.get("input") == "compressible":
        # force a codec every build speaks (the default ladder only offers
        # zstd/lz4 when their packages import); driver and workers spawned
        # below inherit it, so negotiation yields a real codec
        from repro_torch.fabric.wire import COMPRESSION_ENV

        old_comp = os.environ.get(COMPRESSION_ENV)
        os.environ[COMPRESSION_ENV] = "zlib"
    sup = FabricSupervisor(str(store_root), transport=transport, device=device)
    socket_paths = {n: sup.pin(n) for n in _TOUR_NODES}
    x = np.random.default_rng(77).standard_normal((256, 64))
    if cell.get("input") == "compressible":
        # wire compression only engages when a chunk actually shrinks: tile
        # one row so every streamed chunk is highly redundant and the bulk
        # frames carry a real codec marker for the fault to strike
        x = np.tile(x[:1], (256, 1))
    x = torch.from_numpy(x).to(device)
    expected = _tour_expected(x)
    try:
        last: Exception | None = None
        out = nbs = None
        # worst case needs 1 + len(_TOUR_NODES) attempts: workers that
        # SURVIVE attempt 0 still carry the armed plan in their env, so a
        # sigkill cell can take out one further worker per retry before
        # every incarnation is clean
        for attempt in range(1 + len(_TOUR_NODES) + 1):
            try:
                if attempt == 0:
                    # workers spawned inside arm() inherit the plan; the
                    # driver-side strikes fire right here in this process
                    with faults.arm(cell["spec"]):
                        _spawn_missing(sup, socket_paths)
                        out, nbs = _attempt_tour(sup, store_root, x)
                else:
                    # retries run clean: fresh workers must NOT inherit the
                    # plan (per-process counters would make them re-fire it)
                    _spawn_missing(sup, socket_paths)
                    out, nbs = _attempt_tour(sup, store_root, x)
                break
            except Exception as e:  # recovery: respawn dead workers, retry
                last = e
                time.sleep(0.2)
        if out is None:
            raise AssertionError(f"tour did not recover: {last!r}")
        if _host_bytes(out["x"]) != _host_bytes(expected):
            raise AssertionError("recovered tour product is not bit-identical")
        leaked = list(nbs.hop_root.iterdir())
        if leaked:
            raise AssertionError(f"hop namespace leaked transit CMIs: {leaked}")
    finally:
        sup.shutdown()
        if cell.get("input") == "compressible":
            from repro_torch.fabric.wire import COMPRESSION_ENV

            if old_comp is None:
                os.environ.pop(COMPRESSION_ENV, None)
            else:
                os.environ[COMPRESSION_ENV] = old_comp


# ---------------------------------------------------------------------------
# job scenario
# ---------------------------------------------------------------------------

_CLEAN_PRODUCT: dict[str, bytes] = {}  # device -> product bytes


def _product_bytes(js: JobStore, job_id: str) -> bytes:
    job = js.read_job(job_id)
    state, _ = restore_cmi(js.cmi_root(job_id), job.product, device="cpu")
    return _host_bytes(state["w"]) + str(state["t"]).encode()


def _clean_product(device: str) -> bytes:
    """The uninterrupted run's product bytes on ``device`` (computed once
    per device, fault-free)."""
    if device not in _CLEAN_PRODUCT:
        tmp = Path(tempfile.mkdtemp(prefix="chaos-clean-"))
        try:
            js = JobStore(tmp / "jobs")
            sup = FabricSupervisor(str(tmp / "s3"), str(tmp / "jobs"), device=device)
            try:
                job = js.create_job(dict(JOB_INPUT))
                sup.run_job(job.job_id, steps=JOB_INPUT["steps"],
                            publish_every=JOB_INPUT["publish_every"],
                            step_ms=1, timeout_s=120)
                _CLEAN_PRODUCT[device] = _product_bytes(js, job.job_id)
            finally:
                sup.shutdown()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return _CLEAN_PRODUCT[device]


def run_job_cell(cell: dict, tmp: Path, transport: str = "unix",
                 device: str = "cuda") -> None:
    clean = _clean_product(device)  # before arming: this run must stay fault-free
    js = JobStore(tmp / "jobs")
    sup = FabricSupervisor(str(tmp / "s3"), str(tmp / "jobs"), transport=transport,
                           device=device)
    try:
        job = js.create_job(dict(JOB_INPUT))
        # wait=False: the armed fault can SIGKILL the worker before its
        # server ever answers the readiness ping — a spawn that insists on
        # one would burn the whole spawn timeout on an already-dead process.
        # Addresses are pinned so tcp spawns need no ready-file round trip
        # either (an ephemeral-port spawn must block for the resolved port).
        spawn_kw = dict(
            job_id=job.job_id,
            steps=JOB_INPUT["steps"],
            publish_every=JOB_INPUT["publish_every"],
            step_ms=float(cell.get("step_ms", 1.0)),
            lease_s=4.0,
            wait=False,
        )
        with faults.arm(cell["spec"]):
            handle = sup.spawn("w0", socket_path=sup.pin("w0"), **spawn_kw)
        try:
            rc0 = handle.wait(timeout=90)
        finally:
            sup.workers.pop("w0", None)
        # replacements run WITHOUT the plan (a respawn re-reads the env and
        # resets the per-process counters — it would re-fire the fault)
        for i in range(1, 4):
            if js.read_job(job.job_id).status == STATUS_FINISHED:
                break
            handle = sup.spawn(f"w{i}", socket_path=sup.pin(f"w{i}"), **spawn_kw)
            try:
                handle.wait(timeout=90)
            finally:
                sup.workers.pop(f"w{i}", None)
        final = js.read_job(job.job_id)
        if final.status != STATUS_FINISHED:
            raise AssertionError(
                f"job stuck in {final.status!r} after recovery (rc0={rc0})"
            )
        if _product_bytes(js, job.job_id) != clean:
            raise AssertionError("recovered product is not bit-identical")
        if final.lease_owner is not None:
            raise AssertionError(f"stranded lease: {final.lease_owner!r}")
        torn = [p.name for p in js.job_dir(job.job_id).iterdir()
                if ".stage-" in p.name]
        if torn:
            raise AssertionError(f"torn CMI staging dirs survived: {torn}")
        # CAS durability contract: whatever the kill left behind, the store
        # must pass fsck — no torn objects, no dangling manifest refs
        # (orphaned objects/tmp files are the allowed benign residue)
        from repro_torch.checkpoint.fsck import fsck_store

        report = fsck_store(js.cmi_root(job.job_id))
        if not report.clean:
            raise AssertionError(
                f"store failed fsck after recovery: {report.errors}"
            )
    finally:
        sup.shutdown()


# ---------------------------------------------------------------------------
# serve scenario (elastic serving fleet: router + 2 serving workers)
# ---------------------------------------------------------------------------

_SERVE_ENGINE = "toy:d=16,vocab=128,seed=5"
_SERVE_REQS = [
    {"id": f"q{i}", "prompt": [3 + 2 * i, 17, 40 + i, 9], "max_new": 10}
    for i in range(4)
]


def run_serve_cell(cell: dict, tmp: Path, transport: str = "unix",
                   device: str = "cuda") -> None:
    """Serve protocol faults against a 2-worker continuous-batching fleet.

    The oracle is computed in THIS process (the toy engine is elementwise
    numpy, bit-stable across processes); every fault cell must end with all
    four transcripts identical to it, all serve jobs finished with clean
    CAS stores, and an empty hop namespace. ``mode`` picks the churn the
    fault strikes: a live migration, a SIGTERM reclaim, or a bulk drain.
    """
    from repro_torch.serve.engine import make_engine, run_reference
    from repro_torch.serve.router import ServeRouter
    from repro_torch.serve.scenarios import spawn_serve_worker

    expected = run_reference(make_engine(_SERVE_ENGINE), _SERVE_REQS)
    js = JobStore(tmp / "jobs")
    sup = FabricSupervisor(str(tmp / "s3"), str(tmp / "jobs"), transport=transport,
                           device=device)
    router = ServeRouter(jobstore=js)
    try:
        # workers spawned inside arm() inherit the plan; every serve cell is
        # role=worker, so the driver (this process) never strikes
        with faults.arm(cell["spec"]):
            for name in ("s0", "s1"):
                handle = spawn_serve_worker(
                    sup, name, engine_spec=_SERVE_ENGINE,
                    publish_every=3, chunk_bytes=2048,
                )
                router.add_worker(name, handle.address)
            for req in _SERVE_REQS:  # staggered joins: the rolling batch
                router.admit(req["prompt"], req["max_new"], req_id=req["id"])
                router.step()
            mode = cell.get("mode")
            if mode == "reclaim":
                for _ in range(2):
                    router.step()
                # notice arrives, and the armed sigkill cuts the notice path
                # short before publish-all — the 2-minute window "expiring"
                rc = sup.reclaim("s0", notice=True, wait_s=30)
                if rc == 0:
                    raise AssertionError("worker survived the armed notice kill")
                resumed = router.recover("s0", "s1")
                if not resumed:
                    raise AssertionError("no stranded request resumed after kill")
            elif mode == "drain":
                moved = router.drain("s0", "s1")
                drains = [e for e in router.events if e["kind"] == "drain"]
                if drains[-1]["mode"] != "per-request":
                    raise AssertionError(
                        f"bulk drain should have failed over: {drains[-1]}")
                stayed = [r for r in router.assignment
                          if router.assignment[r] == "s0"
                          and r not in router.finished]
                if stayed:
                    raise AssertionError(f"drain left requests behind: {stayed}")
            elif mode == "migrate":
                victim = next(r for r in sorted(router.pending())
                              if router.assignment[r] == "s0")
                event = router.migrate(victim, "s1")
                if event["mode"] != "store":
                    raise AssertionError(
                        f"both stream legs were armed to die; migration should "
                        f"have fallen back to the store: {event}")
            else:  # the admit cell: the strike already hit the first admit
                admitted = {e["req"] for e in router.events if e["kind"] == "admit"}
                if admitted != {r["id"] for r in _SERVE_REQS}:
                    raise AssertionError(f"admission did not recover: {admitted}")
        router.run_to_completion()
        for req in _SERVE_REQS:
            got = router.transcript(req["id"])
            if got != expected[req["id"]]:
                raise AssertionError(
                    f"transcript of {req['id']} diverged after recovery: "
                    f"{got} != {expected[req['id']]}")
        nbs = NBS(tmp / "s3")
        leaked = list(nbs.hop_root.iterdir())
        if leaked:
            raise AssertionError(f"hop namespace leaked transit CMIs: {leaked}")
        from repro_torch.checkpoint.fsck import fsck_store

        for req_id, job_id in router.jobs.items():
            job = js.read_job(job_id)
            if job.status != STATUS_FINISHED:
                raise AssertionError(
                    f"serve job for {req_id} stuck in {job.status!r}")
            if job.lease_owner is not None:
                raise AssertionError(f"stranded lease: {job.lease_owner!r}")
            torn = [p.name for p in js.job_dir(job_id).iterdir()
                    if ".stage-" in p.name]
            if torn:
                raise AssertionError(f"torn CMI staging dirs survived: {torn}")
            report = fsck_store(js.cmi_root(job_id))
            if not report.clean:
                raise AssertionError(
                    f"store for {req_id} failed fsck: {report.errors}")
    finally:
        router.close()
        sup.shutdown()


# ---------------------------------------------------------------------------
# fleet scenario (registry + agent + agent-spawned worker, TCP-native)
# ---------------------------------------------------------------------------


def run_fleet_cell(cell: dict, tmp: Path, device: str = "cuda") -> None:
    """Registry/agent protocol faults against a real three-role fleet.

    Roles: this process is the driver (resolves through the registry), the
    agent is a subprocess, and the worker is the agent's child — two forks
    away, reachable only through what the registry recorded. Default shape:
    SIGKILL the worker, then require DEAD detection, an agent respawn at a
    fresh port under a bumped generation, and live re-resolution. ``mode:
    gap`` cells instead open heartbeat gaps and require SUSPECT -> ALIVE
    with NO respawn — a slow heartbeat must never be treated as a death.
    """
    from repro_torch.fabric.agent import AgentClient, _src_dir
    from repro_torch.fabric.proxy import wait_ready
    from repro_torch.fabric.registry import Registry, RegistryClient, RegistryServer

    registry = Registry(suspect_after_s=0.6, dead_after_s=2.5)
    server = RegistryServer(registry).start()
    reg_spec = f"{server.address[1]}:{server.address[2]}"
    agent_proc = None
    try:
        with faults.arm(cell["spec"]):
            # the agent inherits the armed plan (role scoping aims strikes);
            # its own respawned children run plan-free by agent policy
            env = dict(os.environ)
            env["PYTHONPATH"] = _src_dir() + (
                os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
            )
            agent_proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.fabric.agent",
                 "--registry", reg_spec, "--store", str(tmp / "s3"),
                 "--name", "agent0", "--worker-heartbeat-s", "0.25",
                 "--device", device],
                env=env,
            )
            reg = RegistryClient(server.address)
            agent_rec = reg.wait_state("agent0", "alive", timeout=60)
            with AgentClient(agent_rec["address"]) as agent:
                last: Exception | None = None
                for _ in range(4):  # agent/spawn failures are retryable
                    try:
                        agent.spawn("W", {"serve_only": True})
                        break
                    except Exception as e:
                        last = e
                        time.sleep(0.1)
                else:
                    raise AssertionError(f"agent/spawn never succeeded: {last!r}")
                first = reg.wait_state("W", "alive", timeout=60)
                if cell.get("mode") == "gap":
                    reg.wait_state("W", ("suspect", "dead"), timeout=30)
                    again = reg.wait_state("W", "alive", timeout=30)
                    if again["generation"] != first["generation"]:
                        raise AssertionError(
                            "heartbeat gap caused a respawn (generation bumped)"
                        )
                    if again["pid"] != first["pid"]:
                        raise AssertionError("heartbeat gap replaced the process")
                else:
                    # the worker is the agent's child; its pid is known only
                    # through the registry record — the multi-host reach
                    os.kill(first["pid"], signal.SIGKILL)
                    reg.wait_state("W", "dead", timeout=30)
                    second = reg.wait_state("W", "alive", timeout=60)
                    if second["generation"] <= first["generation"]:
                        raise AssertionError("respawn did not bump the generation")
                    info = wait_ready(second["address"], timeout=30)
                    if info.get("pid") == first["pid"]:
                        raise AssertionError("re-resolved ping answered by the corpse")
                agent.shutdown()
        agent_proc.wait(timeout=30)
    finally:
        if agent_proc is not None and agent_proc.poll() is None:
            agent_proc.kill()
            agent_proc.wait(timeout=10)
        server.stop()


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


def run_cell(cell: dict, transport: str = "unix", device: str = "cuda") -> None:
    """Run one cell with its workers on ``device``; raises on any breach."""
    tmp = Path(tempfile.mkdtemp(prefix=f"chaos-{cell['id'].replace(':', '_').replace('.', '_')}-"))
    try:
        if cell["scenario"] == "tour":
            run_tour_cell(cell, tmp, transport, device)
        elif cell["scenario"] == "fleet":
            run_fleet_cell(cell, tmp, device)  # TCP-native: no transport dimension
        elif cell["scenario"] == "serve":
            run_serve_cell(cell, tmp, transport, device)
        else:
            run_job_cell(cell, tmp, transport, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.chaos.matrix", description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="one cell per protocol family (CI-sized)")
    ap.add_argument("--cells", nargs="*", default=None,
                    help="run only these cell ids")
    ap.add_argument("--list", action="store_true", help="print cell ids and exit")
    ap.add_argument("--registry", action="store_true",
                    help="print the machine-readable cell registry as JSON")
    ap.add_argument("--transport", choices=("unix", "tcp", "both"), default="unix",
                    help="transport for tour/job scenarios (fleet cells are "
                         "TCP-native and run once regardless)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every worker and of this "
                         "process's tour node (default: the CUDA card)")
    args = ap.parse_args(argv)

    registry = cell_registry()  # also validates every cell against SITES
    if args.registry:
        import json

        print(json.dumps(registry, indent=1, sort_keys=True))
        return 0

    cells = CELLS
    if args.smoke:
        cells = [c for c in CELLS if c["id"] in SMOKE_IDS]
    if args.cells:
        unknown = set(args.cells) - {c["id"] for c in CELLS}
        if unknown:
            ap.error(f"unknown cell ids: {sorted(unknown)}")
        cells = [c for c in CELLS if c["id"] in set(args.cells)]
    if args.list:
        for c in cells:
            print(c["id"])
        return 0

    transports = ("unix", "tcp") if args.transport == "both" else (args.transport,)
    runs: list[tuple[dict, str, str]] = []
    for cell in cells:
        if cell["scenario"] == "fleet":
            runs.append((cell, "tcp", cell["id"]))
        else:
            runs.extend(
                (cell, t, f"{cell['id']}[{t}]" if len(transports) > 1 else cell["id"])
                for t in transports
            )

    failures: list[str] = []
    t_start = time.monotonic()
    for i, (cell, transport, label) in enumerate(runs, 1):
        t0 = time.monotonic()
        try:
            run_cell(cell, transport, args.device)
            status = "ok"
        except Exception:
            traceback.print_exc()
            failures.append(label)
            status = "FAIL"
        print(f"[{i:2d}/{len(runs)}] {label:<48s} {status:>4s}  "
              f"({time.monotonic() - t0:5.1f}s)", flush=True)
    print(f"chaos matrix: {len(runs) - len(failures)}/{len(runs)} cells survived "
          f"in {time.monotonic() - t_start:.1f}s")
    if failures:
        print("failed cells:", ", ".join(failures))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
