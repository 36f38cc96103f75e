"""Fabric worker: one NBS node in its own OS process.

``python -m repro_torch.fabric.worker --name B --socket /tmp/b.sock --store S
[--device cuda|cpu] ...``

The worker builds a single-node NBS over the *shared* store root (the
filesystem plays S3) whose node lives on ``--device`` (default: the CUDA
card; a worker asked for a card on a machine without one exits non-zero
before it serves), serves its services on a socket (:class:`NodeServer`),
and — when given a job — runs the paper's Figure 7 worker loop:

    get_job -> (restore from CMI if status=="ckpt") -> step loop
            -> publish("ckpt") at application-chosen points
            -> publish("finished") with the product

Preemption is REAL here, not a raised exception:

* SIGTERM is the cloud's 2-minute notice — ``PreemptionNotice.install_sigterm``
  sets the flag, the loop finishes its current step, publishes a CMI, and
  exits with :data:`EXIT_PREEMPTED`.
* SIGKILL is a no-notice reclaim — the process dies mid-whatever. The
  jobstore's fcntl locks and the CMI commit protocol are what make the next
  incarnation's restore safe (an uncommitted CMI is never referenced by
  ``job.cmi``).

The demo computation is float64 tensors on the worker's device and strictly
deterministic, so a killed-and-resumed run must produce a bit-identical
product to an uninterrupted one on the same device — the acceptance test of
the whole fabric. Several workers may share one card: each creates its own
CUDA context before it answers its first ping.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.chaos import faults
from repro_torch.core.dhp import DHP
from repro_torch.core.jobstore import STATUS_CKPT, STATUS_FINISHED, JobStore, LeaseLost
from repro_torch.core.nbs import NBS
from repro_torch.core.preemption import PreemptionNotice
from repro_torch.fabric.server import NodeServer
from repro_torch.kernels import launch_counts
from repro_torch.utils import logger, resolve_device, warm_cpu_math

EXIT_FINISHED = 0
EXIT_PREEMPTED = 43  # graceful: notice honored, CMI published before exit
EXIT_NO_JOB = 44


# ---------------------------------------------------------------------------
# the deterministic demo job (double precision => cross-process bit-stable)
# ---------------------------------------------------------------------------


def init_state(job_input: dict, device: torch.device | str = "cpu") -> dict[str, Any]:
    rng = np.random.default_rng(int(job_input.get("seed", 0)))
    n = int(job_input.get("n", 4096))
    return {"w": torch.from_numpy(rng.standard_normal(n)).to(device), "t": 0}


def job_step(state: dict[str, Any]) -> dict[str, Any]:
    w, t = state["w"], int(state["t"])
    warm_cpu_math(w)
    w = w * 1.000001 + torch.sin(w) * 1e-3 + (t % 7) * 1e-6
    return {"w": w, "t": t + 1}


# ---------------------------------------------------------------------------
# demo tour stages (Fig. 8: read -> compute -> write)
#
# Module-level so any worker can run them by reference via svc/run_stage
# ("repro_torch.fabric.worker:tour_read" etc.); float64 tensors, computed
# where the state lies, and strictly deterministic, so an interrupted-and-
# resumed tour must produce a bit-identical product — the acceptance test
# of remote itineraries.
# ---------------------------------------------------------------------------


def tour_read(state: dict[str, Any]) -> dict[str, Any]:
    x = state["x"].to(torch.float64)
    return {**state, "x": x * 1.000001 + 0.5}


def tour_compute(state: dict[str, Any]) -> dict[str, Any]:
    x = state["x"].to(torch.float64)
    warm_cpu_math(x)
    return {**state, "x": torch.sin(x) * 2.0 + x * 0.5}


def tour_write(state: dict[str, Any]) -> dict[str, Any]:
    x = state["x"].to(torch.float64)
    return {**state, "x": x - 0.25, "toured": int(state.get("toured", 0)) + 1}


def start_lease_heartbeat(
    jobstore: JobStore, job_id: str, worker: str, lease_s: float
) -> threading.Event:
    """Renew the lease at ``lease_s / 3`` cadence until the returned Event is
    set. A healthy-but-slow worker therefore never loses its job to a lease
    steal; a hung or killed one stops renewing and the lease expires on its
    own, letting another claimant (or the supervisor) take over."""
    stop = threading.Event()

    def beat() -> None:
        interval = max(0.2, lease_s / 3.0)
        while not stop.wait(interval):
            try:
                jobstore.renew_lease(job_id, worker, lease_s)
            except LeaseLost as e:
                logger.warning("worker %s lost lease on job %s: %s", worker, job_id, e)
                return
            except Exception:
                logger.exception("lease heartbeat failed for job %s", job_id)
                return

    threading.Thread(target=beat, name="lease-heartbeat", daemon=True).start()
    return stop


def run_job_loop(
    dhp: DHP,
    jobstore: JobStore,
    notice: PreemptionNotice,
    *,
    job_id: str | None,
    worker_name: str,
    steps: int,
    publish_every: int,
    step_ms: float,
    lease_s: float,
) -> int:
    """Claim and run one job to completion (or graceful preemption exit)."""
    job = jobstore.svc_get_job(job_id, worker=worker_name, lease_s=lease_s)
    if job is None:
        logger.info("worker %s: no claimable job", worker_name)
        return EXIT_NO_JOB
    if job.status == STATUS_FINISHED:
        logger.info("worker %s: job %s already finished", worker_name, job.job_id)
        return EXIT_FINISHED
    heartbeat = start_lease_heartbeat(jobstore, job.job_id, worker_name, lease_s)
    try:
        return _run_claimed_job(
            dhp, jobstore, notice, job,
            worker_name=worker_name, steps=steps,
            publish_every=publish_every, step_ms=step_ms,
        )
    finally:
        heartbeat.set()


def _run_claimed_job(
    dhp: DHP,
    jobstore: JobStore,
    notice: PreemptionNotice,
    job,
    *,
    worker_name: str,
    steps: int,
    publish_every: int,
    step_ms: float,
) -> int:
    if job.status == STATUS_CKPT and job.cmi is not None:
        state, _ = dhp.restart(job.job_id)
        logger.info(
            "worker %s resumes job %s at t=%d from %s",
            worker_name, job.job_id, int(state["t"]), job.cmi,
        )
    else:
        state = init_state(job.input, dhp.nbs.node(dhp.node).device)
    steps = int(job.input.get("steps", steps))
    publish_every = int(job.input.get("publish_every", publish_every))
    last_publish_s: float | None = None  # measured cost of the last publish
    while int(state["t"]) < steps:
        if notice.imminent():
            # 2-minute-notice path: publish what we have and exit cleanly —
            # UNLESS the measured publish cost no longer fits the remaining
            # grace. Starting a doomed publish would get SIGKILLed
            # mid-COMMIT and burn the grace for nothing; the last published
            # CMI is already durable, so skipping loses only the steps since
            # then (exactly what a no-notice kill would have lost anyway).
            if last_publish_s is None or notice.can_fit(last_publish_s):
                dhp.publish(job.job_id, STATUS_CKPT, state, step=int(state["t"]))
                dhp.flush()
                logger.warning(
                    "worker %s preempted at t=%d (%.0fs grace left); published + exiting",
                    worker_name, int(state["t"]), notice.time_left(),
                )
            else:
                logger.warning(
                    "worker %s preempted at t=%d: %.2fs grace < ~%.2fs publish "
                    "cost; skipping doomed publish + exiting",
                    worker_name, int(state["t"]), notice.time_left(), last_publish_s,
                )
            return EXIT_PREEMPTED
        state = job_step(state)
        if step_ms > 0:
            time.sleep(step_ms / 1000.0)
        t = int(state["t"])
        if publish_every > 0 and t % publish_every == 0 and t < steps:
            t0 = time.monotonic()
            dhp.publish(job.job_id, STATUS_CKPT, state, step=t)
            last_publish_s = time.monotonic() - t0
    dhp.flush()
    dhp.publish(
        job.job_id, STATUS_FINISHED, product={"w": state["w"], "t": int(state["t"])},
        step=int(state["t"]),
    )
    logger.info("worker %s finished job %s at t=%d", worker_name, job.job_id, int(state["t"]))
    return EXIT_FINISHED


# ---------------------------------------------------------------------------
# entrypoint
# ---------------------------------------------------------------------------


def open_device(spec: str) -> torch.device:
    """The worker's device, with this process's CUDA context made before it
    serves; raises (a non-zero exit, before serving) where the card asked
    for is absent."""
    device = resolve_device(spec)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.zeros(1, device=device)
    return device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.fabric.worker")
    ap.add_argument("--name", required=True, help="node name")
    ap.add_argument("--device", default="cuda",
                    help="torch device of this node (default: the CUDA card; cpu on request)")
    ap.add_argument("--store", required=True, help="shared NBS store root")
    ap.add_argument("--socket", default="", help="unix socket path to serve on")
    ap.add_argument("--tcp", default="", help="host:port to serve on (port 0 = ephemeral)")
    ap.add_argument("--jobstore", default="", help="shared jobstore root")
    ap.add_argument("--job-id", default="", help="run this job (empty + --claim: next job)")
    ap.add_argument("--claim", action="store_true", help="claim the next unleased job")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--publish-every", type=int, default=10)
    ap.add_argument("--step-ms", type=float, default=0.0, help="artificial per-step pacing")
    ap.add_argument("--lease-s", type=float, default=60.0)
    ap.add_argument("--grace-s", type=float, default=120.0, help="SIGTERM notice grace")
    ap.add_argument("--writers", type=int, default=1, help="CMI save stripes (1 = bit-stable layout)")
    ap.add_argument("--ready-file", default="", help="write {pid, address} here once serving")
    ap.add_argument("--serve-only", action="store_true", help="no job loop; serve until shutdown")
    ap.add_argument("--registry", default="",
                    help="registry host:port — register name -> address and heartbeat")
    ap.add_argument("--heartbeat-s", type=float, default=0.5,
                    help="registry heartbeat interval")
    return ap


@dataclass
class NodeProcess:
    """What a worker process serves with: its node on the shared store, the
    server answering for it, and the termination notice."""

    name: str
    device: torch.device
    nbs: NBS
    node: Any
    jobstore: JobStore | None
    server: NodeServer
    notice: PreemptionNotice


def run_node_process(
    args: argparse.Namespace,
    body: Callable[[NodeProcess], int],
    *,
    setup: Callable[[NodeProcess], None] | None = None,
) -> int:
    """The process protocol every worker keeps (the supervisor and the
    agents rely on it), around ``body(proc)``: open ``--device``, bind the
    node ``--name``'s server on ``--socket`` or ``--tcp`` with
    ``svc/kernel_launches`` on it, let ``setup(proc)`` add the worker's own
    services, and only then serve — a caller that reaches the address
    during a slow setup (a model built on the card) waits instead of
    finding a node without them — and announce the worker: SIGTERM as the
    notice, the ready-file, the registry's registration and heartbeat.
    Returns ``body``'s exit code; the heartbeat and the server stop after
    it."""
    if args.tcp:
        host, _, port = args.tcp.rpartition(":")
        address = ("tcp", host or "127.0.0.1", int(port or 0))
    elif args.socket:
        address = ("unix", args.socket)
    else:
        raise SystemExit("worker needs --socket or --tcp")

    faults.set_role("worker", node=args.name)  # scope inherited fault plans
    device = open_device(args.device)
    nbs = NBS(args.store)
    node = nbs.add_node(args.name, device=device)
    # svc/kernel_launches: how a driver sees the kernels run in here
    node.register("svc/kernel_launches", launch_counts)
    jobstore = JobStore(args.jobstore) if args.jobstore else None
    server = NodeServer(nbs, args.name, address, jobstore=jobstore)
    proc = NodeProcess(args.name, device, nbs, node, jobstore, server, PreemptionNotice())
    heartbeat_stop: threading.Event | None = None
    try:
        if setup is not None:
            setup(proc)
        server.start()
        if os.environ.get("REPRO_CHAOS_IGNORE_SIGTERM"):
            # chaos: a worker that ignores the termination notice (hung
            # signal handler) — supervisor escalation paths are tested
            # against this
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
        else:
            proc.notice.install_sigterm(args.grace_s)

        if args.ready_file:
            tmp = Path(args.ready_file + ".tmp")
            tmp.write_text(json.dumps({"pid": os.getpid(), "address": list(server.address)}))
            os.replace(tmp, args.ready_file)

        if args.registry:
            # announce this incarnation: name -> resolved (host, port). A
            # respawn re-registers under a NEW generation (and usually a new
            # ephemeral port) — that is the cache-invalidation signal drivers
            # resolve against. Registration failure is fatal on purpose: an
            # unreachable registry means nobody can find this worker, and a
            # crash here is a respawn the agent knows how to retry.
            from repro_torch.fabric.registry import RegistryClient, tcp_address

            registry = RegistryClient(tcp_address(args.registry))
            generation = registry.register(
                args.name, server.address, pid=os.getpid(), kind="worker"
            )
            heartbeat_stop = registry.start_heartbeat(
                args.name, generation, interval_s=args.heartbeat_s
            )
        return body(proc)
    finally:
        if heartbeat_stop is not None:
            # stop beating but keep the record: the registry (not this
            # process) decides what the exit means — an agent's report_exit
            # or the heartbeat gap marks it DEAD with the exit preserved
            heartbeat_stop.set()
        server.stop()


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    def body(proc: NodeProcess) -> int:
        if args.serve_only or not (args.job_id or args.claim) or proc.jobstore is None:
            proc.server.serve_forever(until=proc.notice.imminent)
            return EXIT_PREEMPTED if proc.notice.imminent() else EXIT_FINISHED
        dhp = DHP(proc.nbs, args.name, proc.jobstore, writers=args.writers)
        return run_job_loop(
            dhp, proc.jobstore, proc.notice,
            job_id=args.job_id or None,
            worker_name=args.name,
            steps=args.steps,
            publish_every=args.publish_every,
            step_ms=args.step_ms,
            lease_s=args.lease_s,
        )

    return run_node_process(args, body)


if __name__ == "__main__":
    sys.exit(main())
