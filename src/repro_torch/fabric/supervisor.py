"""FabricSupervisor: spawn, watch, reclaim, and replace worker processes.

This is the Spot-on shape (PAPERS: *Spot-on*, 2022): a supervisor outside the
computation drives real OS signals at it and re-provisions instances, while
the application's own checkpoint discipline (publish at chosen points) makes
the kills survivable — *Checkpointing as a Service* rendered as a local
process fabric.

Reclaim paths, both real:

* ``notice=True``  -> SIGTERM. The worker's ``PreemptionNotice`` flag flips,
  it finishes the current step, publishes a CMI, exits ``EXIT_PREEMPTED``.
* ``notice=False`` -> SIGKILL. No flag, no flush, the process is gone. The
  next incarnation restores from the last *committed* CMI.

``run_job`` is the supervision loop: it watches the jobstore for published
progress, consults a :class:`SpotSchedule` once per newly observed step, and
replaces reclaimed workers until the job publishes "finished".

Workers are ``python -m repro_torch.fabric.worker`` processes started by
``subprocess.Popen`` (fork + exec: nothing of a parent's CUDA state crosses
into a child), each on the supervisor's ``device`` (default: the CUDA
card), passed as ``--device``; several workers may share one card.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from dataclasses import dataclass, field
from pathlib import Path

import repro_torch
from repro_torch.core.jobstore import STATUS_FINISHED, JobStore
from repro_torch.core.preemption import SpotSchedule
from repro_torch.fabric.proxy import wait_ready
from repro_torch.utils import logger

_SRC_DIR = str(Path(repro_torch.__file__).resolve().parent.parent)


@dataclass
class WorkerHandle:
    name: str
    proc: subprocess.Popen
    address: tuple
    ready_file: str

    @property
    def pid(self) -> int:
        return self.proc.pid

    @property
    def returncode(self) -> int | None:
        return self.proc.returncode

    def alive(self) -> bool:
        return self.proc.poll() is None

    def wait(self, timeout: float | None = None) -> int:
        return self.proc.wait(timeout=timeout)

    def send_signal(self, sig: int) -> None:
        self.proc.send_signal(sig)

    def terminate(self) -> None:
        self.proc.terminate()

    def kill(self) -> None:
        self.proc.kill()


@dataclass
class AgentWorkerHandle:
    """A worker the supervisor did NOT fork: it lives behind a host agent.

    Signals, liveness, and exit codes all travel over the agent's wire
    services — the duck type matches :class:`WorkerHandle`, so ``reclaim``/
    ``shutdown``/``run_job`` manage foreign fleets unchanged. A signal sent
    through this handle is a *deliberate* stop: the agent disables its
    auto-respawn for that child first (failure-respawn stays reserved for
    deaths the agent did not order).
    """

    name: str
    agent: "object"  # repro_torch.fabric.agent.AgentClient (kept lazy)
    pid: int
    address: tuple | None = None
    ready_file: str = ""

    def _info(self) -> dict | None:
        for child in self.agent.list_children():
            if child["name"] == self.name:
                return child
        return None

    @property
    def returncode(self) -> int | None:
        info = self._info()
        return None if info is None else info["rc"]

    def alive(self) -> bool:
        info = self._info()
        return info is not None and info["state"] == "running"

    def wait(self, timeout: float | None = None) -> int:
        rc = self.agent.wait_child(self.name, timeout_s=timeout)
        if rc is None:
            raise subprocess.TimeoutExpired(f"agent:{self.name}", timeout or 0.0)
        return rc

    def send_signal(self, sig: int) -> None:
        self.agent.stop_child(self.name, sig, respawn=False)

    def terminate(self) -> None:
        self.send_signal(signal.SIGTERM)

    def kill(self) -> None:
        self.send_signal(signal.SIGKILL)


@dataclass
class FabricSupervisor:
    store_root: str
    jobstore_root: str | None = None
    python: str = sys.executable
    spawn_timeout_s: float = 90.0
    socket_dir: str = ""
    # "unix" (default: sockets under socket_dir) or "tcp" (127.0.0.1,
    # ephemeral ports — the wire path real multi-host fleets use)
    transport: str = "unix"
    # registry host:port tuple; when set, every spawned worker registers
    # itself and heartbeats there, and fleet handles resolve through it
    registry_addr: tuple | None = None
    heartbeat_s: float = 0.5
    # torch device of every worker this supervisor spawns ("cuda" or "cpu")
    device: str = "cuda"
    workers: dict[str, WorkerHandle] = field(default_factory=dict)
    incarnations: int = 0

    def __post_init__(self) -> None:
        if not self.socket_dir:
            # unix socket paths are capped at ~107 bytes; pytest tmp dirs can
            # blow that, so sockets live in their own short-lived /tmp dir
            self.socket_dir = tempfile.mkdtemp(prefix="navp-fab-")
        if self.transport not in ("unix", "tcp"):
            raise ValueError(f"unknown transport {self.transport!r}")

    # -- spawn / reclaim ----------------------------------------------------
    def pin(self, name: str) -> str:
        """A stable bind spec replacements can respawn *in place* at:
        a socket path for unix, a reserved ``host:port`` for tcp."""
        if self.transport == "tcp":
            with socket.socket() as probe:
                probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                probe.bind(("127.0.0.1", 0))
                port = probe.getsockname()[1]
            return f"127.0.0.1:{port}"
        return os.path.join(self.socket_dir, f"{name}-pinned.sock")

    def spawn(
        self,
        name: str,
        *,
        module: str = "repro_torch.fabric.worker",
        job_id: str | None = None,
        claim: bool = False,
        steps: int = 50,
        publish_every: int = 10,
        step_ms: float = 0.0,
        lease_s: float = 60.0,
        grace_s: float = 120.0,
        serve_only: bool = False,
        wait: bool = True,
        extra_args: list[str] | None = None,
        socket_path: str | None = None,
        device: str | None = None,
    ) -> WorkerHandle:
        """Provision a worker process and (unless ``wait=False``) wait for
        its server to answer. ``wait=False`` suits racing claimants that may
        legitimately exit before ever being pinged. ``socket_path`` pins the
        listen address (a unix path or a tcp ``host:port`` spec, see
        :meth:`pin`) — a replacement worker spawned at a dead worker's
        address is a respawn-in-place, and clients reconnect transparently.
        On tcp without a pin the worker binds an ephemeral port; the real
        address comes back through the ready-file (and the registry, when
        one is configured). ``module`` selects the worker entrypoint —
        ``repro_torch.serve.worker`` provisions a serving worker (same flag
        surface; ``extra_args`` carries its ``--engine`` spec). ``device``
        (default: the supervisor's) is the worker's ``--device``."""
        os.makedirs(self.socket_dir, exist_ok=True)
        ready = os.path.join(self.socket_dir, f"{name}-{uuid.uuid4().hex[:6]}.ready")
        if self.transport == "tcp":
            bind = socket_path or "127.0.0.1:0"
            addr_args = ["--tcp", bind]
        else:
            bind = socket_path or os.path.join(
                self.socket_dir, f"{name}-{uuid.uuid4().hex[:6]}.sock"
            )
            addr_args = ["--socket", bind]
        cmd = [
            self.python, "-m", module,
            "--name", name,
            "--device", str(device or self.device),
            "--store", str(self.store_root),
            *addr_args,
            "--ready-file", ready,
            "--steps", str(steps),
            "--publish-every", str(publish_every),
            "--step-ms", str(step_ms),
            "--lease-s", str(lease_s),
            "--grace-s", str(grace_s),
        ]
        if self.registry_addr is not None:
            cmd += [
                "--registry", f"{self.registry_addr[1]}:{self.registry_addr[2]}",
                "--heartbeat-s", str(self.heartbeat_s),
            ]
        if self.jobstore_root:
            cmd += ["--jobstore", str(self.jobstore_root)]
        if job_id is not None:
            cmd += ["--job-id", str(job_id)]
        if claim:
            cmd += ["--claim"]
        if serve_only:
            cmd += ["--serve-only"]
        cmd += extra_args or []
        env = dict(os.environ)
        env["PYTHONPATH"] = _SRC_DIR + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
        )
        proc = subprocess.Popen(cmd, env=env)
        if self.transport == "tcp":
            host, _, port = bind.rpartition(":")
            if int(port or 0):
                address = ("tcp", host or "127.0.0.1", int(port))
            else:
                # ephemeral bind: the worker announces the resolved port in
                # its ready-file before it starts serving
                address = self._await_ready_address(proc, name, ready)
        else:
            address = ("unix", bind)
        if wait:
            # Poll readiness in short slices, checking the process between
            # attempts: a startup crash fails fast instead of burning the
            # whole spawn timeout, and a short-lived job worker that runs to
            # completion (rc=0) before a ping can land is a success, not a
            # startup death — its exit code is the readiness signal.
            deadline = time.monotonic() + self.spawn_timeout_s
            while True:
                try:
                    wait_ready(address, timeout=min(2.0, max(0.1, deadline - time.monotonic())))
                    break
                except TimeoutError:
                    if proc.poll() is not None:
                        if proc.returncode == 0:
                            break
                        raise RuntimeError(
                            f"worker {name} died during startup (rc={proc.returncode})"
                        ) from None
                    if time.monotonic() >= deadline:
                        proc.kill()
                        try:
                            proc.wait(timeout=10)  # reap: no zombies on retry loops
                        except subprocess.TimeoutExpired:
                            pass
                        raise TimeoutError(
                            f"no fabric server at {address} after {self.spawn_timeout_s}s"
                        ) from None
        handle = WorkerHandle(name=name, proc=proc, address=address, ready_file=ready)
        self.workers[name] = handle
        self.incarnations += 1
        logger.info("spawned worker %s pid=%d on %s", name, proc.pid, address)
        return handle

    def _await_ready_address(
        self, proc: subprocess.Popen, name: str, ready: str
    ) -> tuple:
        """Poll for the worker's ready-file and return the address it bound.

        Only needed for ephemeral tcp binds: with port 0 the listen address
        does not exist until the worker resolves it, so the ready-file is the
        address channel (same contract ``read_ready`` exposes to tests)."""
        deadline = time.monotonic() + self.spawn_timeout_s
        while time.monotonic() < deadline:
            if os.path.exists(ready):
                try:
                    return self.read_ready(ready)["address"]
                except (OSError, json.JSONDecodeError, KeyError):
                    pass  # racing the atomic rename; retry
            if proc.poll() is not None:
                raise RuntimeError(
                    f"worker {name} died before announcing its address "
                    f"(rc={proc.returncode})"
                )
            time.sleep(0.01)
        proc.kill()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
        raise TimeoutError(f"worker {name} never announced its address")

    def adopt(self, name: str, agent, *, address: tuple | None = None,
              pid: int = 0) -> "AgentWorkerHandle":
        """Take supervision of a worker some host agent spawned.

        The returned handle routes signals/waits through the agent's wire
        services, so ``reclaim``/``shutdown``/``run_job`` manage a fleet this
        process never forked — the multi-host role split."""
        handle = AgentWorkerHandle(name=name, agent=agent, pid=pid, address=address)
        self.workers[name] = handle
        self.incarnations += 1
        return handle

    def reclaim(self, name: str, *, notice: bool = True, wait_s: float = 60.0) -> int:
        """Take the instance away. notice=True: SIGTERM; False: SIGKILL.

        The cloud's notice is a *deadline*, not a request: a worker that has
        not exited ``wait_s`` after its SIGTERM (hung handler, SIGTERM
        ignored) is SIGKILLed — exactly what EC2 does when the 2-minute
        grace expires.
        """
        handle = self.workers[name]
        sig = signal.SIGTERM if notice else signal.SIGKILL
        logger.warning("reclaiming worker %s pid=%d via %s", name, handle.pid, sig.name)
        try:
            handle.send_signal(sig)
        except ProcessLookupError:
            pass
        try:
            rc = handle.wait(timeout=wait_s)
        except subprocess.TimeoutExpired:
            if not notice:
                raise  # SIGKILL not taking effect is a real problem
            logger.warning(
                "worker %s ignored SIGTERM for %.1fs; escalating to SIGKILL",
                name, wait_s,
            )
            handle.kill()
            rc = handle.wait(timeout=10)
        self.workers.pop(name, None)
        return rc

    def shutdown(self, *, wait_s: float = 2.0) -> None:
        """Stop every worker: SIGTERM all, bounded wait, SIGKILL stragglers.

        The polite pass lets healthy workers publish their final CMI; the
        escalation bounds teardown time against hung or SIGTERM-ignoring
        processes (the same deadline semantics as :meth:`reclaim`).
        """
        handles = [self.workers.pop(name) for name in list(self.workers)]
        for handle in handles:
            if handle.alive():
                try:
                    handle.terminate()
                except ProcessLookupError:
                    pass
        deadline = time.monotonic() + wait_s
        for handle in handles:
            if handle.alive():
                try:
                    handle.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    logger.warning(
                        "worker %s still alive %.1fs after SIGTERM; killing",
                        handle.name, wait_s,
                    )
                    handle.kill()
        for handle in handles:  # reap everything: no zombies
            try:
                handle.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        shutil.rmtree(self.socket_dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- supervision loop ---------------------------------------------------
    def run_job(
        self,
        job_id: str,
        *,
        schedule: SpotSchedule | None = None,
        notice: bool = True,
        steps: int = 50,
        publish_every: int = 5,
        step_ms: float = 5.0,
        grace_s: float = 120.0,
        max_restarts: int = 16,
        poll_s: float = 0.05,
        timeout_s: float = 600.0,
    ) -> dict:
        """Drive ``job_id`` to "finished" across real reclaims.

        Returns ``{"incarnations": n, "reclaims": m, "job": job_dict}``.
        """
        if not self.jobstore_root:
            raise RuntimeError("run_job requires a jobstore_root")
        store = JobStore(self.jobstore_root)
        deadline = time.monotonic() + timeout_s
        reclaims = 0
        incarnation = 0
        seen_step = -1
        name = f"w{uuid.uuid4().hex[:4]}-0"
        self.spawn(
            name, job_id=job_id, steps=steps, publish_every=publish_every,
            step_ms=step_ms, grace_s=grace_s,
        )
        while True:
            if time.monotonic() > deadline:
                # kill only OUR worker: run_fleet drives several run_job
                # loops over one supervisor, so a fleet-wide shutdown here
                # would shoot other jobs' healthy workers
                if name in self.workers:
                    self.reclaim(name, notice=False, wait_s=10.0)
                raise TimeoutError(f"job {job_id} did not finish in {timeout_s}s")
            job = store.read_job(job_id)
            if job.status == STATUS_FINISHED:
                if name in self.workers:
                    try:
                        self.workers[name].wait(timeout=30)
                    except subprocess.TimeoutExpired:
                        pass
                    self.workers.pop(name, None)
                return {
                    "incarnations": incarnation + 1,
                    "reclaims": reclaims,
                    "job": job.to_json(),
                }
            # consult the spot market once per newly published step
            if schedule is not None and job.step > seen_step:
                preempt = False
                for s in range(seen_step + 1, job.step + 1):
                    if schedule.should_preempt(s):
                        preempt = True
                seen_step = job.step
                if preempt and name in self.workers:
                    # per-event notice mix: a trace-driven schedule decides
                    # whether THIS reclaim ships with the 2-minute warning
                    # (SIGTERM) or is a no-notice capacity grab (SIGKILL)
                    ev_notice = notice and (
                        schedule.draw_notice()
                        if hasattr(schedule, "draw_notice") else True
                    )
                    self.reclaim(name, notice=ev_notice, wait_s=grace_s + 10.0)
                    reclaims += 1
                    if incarnation >= max_restarts:
                        raise RuntimeError(f"exceeded {max_restarts} restarts")
                    incarnation += 1
                    name = f"{name.rsplit('-', 1)[0]}-{incarnation}"
                    self.spawn(
                        name, job_id=job_id, steps=steps,
                        publish_every=publish_every, step_ms=step_ms, grace_s=grace_s,
                    )
                    continue
            # lease-expiry watchdog: a worker that claimed the job but let
            # its lease lapse (hung process — heartbeats stopped without the
            # process dying) is reclaimed and replaced. Guarded on
            # lease_owner == this incarnation so a fresh spawn that has not
            # claimed yet is never shot over its predecessor's stale lease.
            if (
                job.lease_owner == name
                and not job.leased()
                and name in self.workers
                and self.workers[name].alive()
            ):
                logger.warning(
                    "worker %s let its lease on job %s expire; reclaiming", name, job_id
                )
                self.reclaim(name, notice=False)
                reclaims += 1
                if incarnation >= max_restarts:
                    raise RuntimeError(f"exceeded {max_restarts} restarts")
                incarnation += 1
                name = f"{name.rsplit('-', 1)[0]}-{incarnation}"
                self.spawn(
                    name, job_id=job_id, steps=steps,
                    publish_every=publish_every, step_ms=step_ms, grace_s=grace_s,
                )
                continue
            handle = self.workers.get(name)
            if handle is not None and not handle.alive():
                rc = handle.returncode
                self.workers.pop(name, None)
                job = store.read_job(job_id)
                if job.status == STATUS_FINISHED:
                    continue  # loop top records the finish
                # died (preempted externally or crashed): re-provision
                logger.warning("worker %s exited rc=%s; re-provisioning", name, rc)
                if incarnation >= max_restarts:
                    raise RuntimeError(f"exceeded {max_restarts} restarts")
                incarnation += 1
                name = f"{name.rsplit('-', 1)[0]}-{incarnation}"
                self.spawn(
                    name, job_id=job_id, steps=steps,
                    publish_every=publish_every, step_ms=step_ms, grace_s=grace_s,
                )
            time.sleep(poll_s)

    def run_fleet(
        self,
        job_ids: list[str],
        fleet,
        *,
        steps: int = 50,
        publish_every: int = 5,
        step_ms: float = 5.0,
        grace_s: float = 120.0,
        max_restarts: int = 16,
        timeout_s: float = 600.0,
    ) -> dict[str, dict]:
        """Drive several jobs concurrently under a :class:`FleetSchedule`.

        Each job gets its own supervision thread and its own per-node hazard
        stream from ``fleet.node_schedule``; correlated fleet shocks land on
        every thread at the same step index — a capacity crunch takes out
        multiple workers in one sweep, and every job must still converge to
        "finished". Returns ``{job_id: run_job result}``; raises the first
        per-job failure after all threads settle.
        """
        results: dict[str, dict] = {}
        errors: dict[str, BaseException] = {}

        def drive(jid: str, node_name: str) -> None:
            try:
                results[jid] = self.run_job(
                    jid,
                    schedule=fleet.node_schedule(node_name),
                    steps=steps, publish_every=publish_every, step_ms=step_ms,
                    grace_s=grace_s, max_restarts=max_restarts,
                    timeout_s=timeout_s,
                )
            except BaseException as e:  # surfaced after join
                errors[jid] = e

        threads = [
            threading.Thread(target=drive, args=(jid, f"node{i}"),
                             name=f"fleet-{jid}", daemon=True)
            for i, jid in enumerate(job_ids)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            jid, err = next(iter(errors.items()))
            raise RuntimeError(f"fleet job {jid} failed: {err!r}") from err
        return results

    # -- helpers ------------------------------------------------------------
    @staticmethod
    def read_ready(ready_file: str) -> dict:
        d = json.loads(Path(ready_file).read_text())
        d["address"] = tuple(d["address"])
        return d
