"""Per-host agent: spawn/respawn workers the driver cannot fork itself.

``python -m repro_torch.fabric.agent --registry HOST:PORT --store S3 ...``

The agent is the missing role in a multi-host fleet: the supervisor/driver
runs on one machine, the workers on others — ``subprocess.Popen`` and
``os.kill`` do not reach across hosts. One agent per host:

* registers itself with the registry (``kind="agent"``) and heartbeats,
* serves ``agent/*`` over the wire — ``agent/spawn`` provisions a worker
  (always ``--tcp host:0``: ephemeral port, announced to the registry by
  the worker itself), ``agent/stop`` delivers signals by *name*,
  ``agent/list``/``agent/wait`` report child state and exit codes,
* **watches** its children: an exit it did not order is reported to the
  registry (``reg/report_exit`` — exit codes beat heartbeat-gap inference)
  and, under the default respawn policy, the worker is relaunched at a NEW
  ephemeral port. The fresh incarnation re-registers, the registry bumps
  its generation, and drivers re-resolve — nobody reconnects to the corpse.

Respawned children get a *clean* fault-plan environment: chaos hit counters
are per-process, so an inherited ``REPRO_FAULT_PLAN`` would re-fire the same
fault in every incarnation and the fleet would crash-loop instead of
recovering (the same rule the chaos matrix applies to its replacements).

The module holds no state and starts no device (wire + registry client
only), so the agent process is cheap enough to leave resident on every
host. Its workers are ``python -m repro_torch.fabric.worker`` processes on
the device the spawn names (``device``; default the agent's, ``cuda``).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from repro_torch.chaos import faults
from repro_torch.fabric import wire
from repro_torch.fabric.registry import (
    RegistryClient,
    ServiceClient,
    tcp_address,
)
from repro_torch.utils import logger

# worker args that agent/spawn is allowed to forward (everything else in the
# worker's argv is the agent's business: addresses, stores, ready files)
_SPAWN_ARG_WHITELIST = {
    "job_id", "claim", "serve_only", "steps", "publish_every", "step_ms",
    "lease_s", "grace_s", "writers", "heartbeat_s", "device",
}

RUNNING = "running"
RESPAWNING = "respawning"
EXITED = "exited"


def _src_dir() -> str:
    import repro_torch

    return str(Path(repro_torch.__file__).resolve().parent.parent)


@dataclass
class ChildRecord:
    name: str
    proc: subprocess.Popen
    spec: dict  # the sanitized agent/spawn args (respawns reuse them)
    respawn: bool = True
    restarts: int = 0
    state: str = RUNNING
    last_rc: int | None = None
    next_retry: float = 0.0  # monotonic; backoff for failed respawn attempts

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "pid": self.proc.pid,
            "state": self.state,
            "rc": self.last_rc,
            "restarts": self.restarts,
            "respawn": self.respawn,
        }


class Agent:
    """The host agent: a child table, a watch loop, and an ``agent/*`` server."""

    def __init__(
        self,
        *,
        store_root: str,
        registry_addr: tuple | None = None,
        jobstore_root: str | None = None,
        name: str = "",
        host: str = "127.0.0.1",
        address=None,
        python: str = sys.executable,
        max_restarts: int = 8,
        poll_s: float = 0.1,
        worker_heartbeat_s: float = 0.5,
        device: str = "cuda",
    ):
        self.store_root = str(store_root)
        self.registry_addr = tuple(registry_addr) if registry_addr else None
        self.jobstore_root = str(jobstore_root) if jobstore_root else None
        self.host = host
        self.python = python
        self.max_restarts = max_restarts
        self.poll_s = poll_s
        self.worker_heartbeat_s = worker_heartbeat_s
        self.device = device
        self.children: dict[str, ChildRecord] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._listener, self.address = wire.listen(
            address if address is not None else ("tcp", host, 0)
        )
        self.name = name or f"agent@{self.address[1]}:{self.address[2]}"
        self._registry: RegistryClient | None = (
            RegistryClient(self.registry_addr) if self.registry_addr else None
        )
        self._heartbeat_stop: threading.Event | None = None
        self._threads: list[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Agent":
        if self._registry is not None:
            generation = self._registry.register(
                self.name, self.address, pid=os.getpid(), kind="agent",
                meta={"host": self.host},
            )
            self._heartbeat_stop = self._registry.start_heartbeat(
                self.name, generation, interval_s=self.worker_heartbeat_s,
            )
        for target, tname in ((self._accept_loop, "agent-accept"),
                              (self._watch_loop, "agent-watch")):
            t = threading.Thread(target=target, name=tname, daemon=True)
            t.start()
            self._threads.append(t)
        logger.info("agent %s serving on %s", self.name, self.address)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._heartbeat_stop is not None:
            self._heartbeat_stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            children = list(self.children.values())
        for child in children:
            child.respawn = False
            if child.proc.poll() is None:
                try:
                    child.proc.terminate()
                except ProcessLookupError:
                    pass
        deadline = time.monotonic() + 5.0
        for child in children:
            try:
                child.proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                child.proc.kill()
        for child in children:  # reap: no zombies
            try:
                child.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        if self._registry is not None:
            try:
                self._registry.deregister(self.name)
            except Exception:
                pass
            self._registry.close()

    def serve_forever(self, poll_s: float = 0.2, until=None) -> None:
        while not self._stop.wait(poll_s):
            if until is not None and until():
                return

    # -- child management ------------------------------------------------------
    def _worker_cmd(self, name: str, spec: dict) -> list[str]:
        cmd = [
            self.python, "-m", "repro_torch.fabric.worker",
            "--name", name,
            "--store", self.store_root,
            "--tcp", f"{self.host}:0",  # ephemeral: every incarnation re-announces
            "--device", str(spec.get("device", self.device)),
        ]
        if self.registry_addr is not None:
            cmd += ["--registry", f"{self.registry_addr[1]}:{self.registry_addr[2]}",
                    "--heartbeat-s",
                    str(spec.get("heartbeat_s", self.worker_heartbeat_s))]
        if self.jobstore_root:
            cmd += ["--jobstore", self.jobstore_root]
        if spec.get("job_id"):
            cmd += ["--job-id", str(spec["job_id"])]
        if spec.get("claim"):
            cmd += ["--claim"]
        if spec.get("serve_only", True):
            cmd += ["--serve-only"]
        for arg in ("steps", "publish_every", "step_ms", "lease_s", "grace_s",
                    "writers"):
            if arg in spec:
                cmd += [f"--{arg.replace('_', '-')}", str(spec[arg])]
        return cmd

    def _launch(self, name: str, spec: dict, *, clean_fault_env: bool) -> subprocess.Popen:
        env = dict(os.environ)
        env["PYTHONPATH"] = _src_dir() + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
        )
        if clean_fault_env:
            env.pop(faults.ENV_VAR, None)
        return subprocess.Popen(self._worker_cmd(name, spec), env=env)

    def spawn(self, name: str, args: dict | None = None, *,
              respawn: bool = True) -> dict:
        """Provision a worker. The worker announces its resolved address to
        the registry itself; callers discover it there, not here."""
        # chaos point: a spawn request that fails before the fork — callers
        # (supervisors, fleet bring-up loops) must treat it as retryable
        faults.fire("agent.spawn")
        spec = {k: v for k, v in (args or {}).items() if k in _SPAWN_ARG_WHITELIST}
        with self._lock:
            existing = self.children.get(name)
            if existing is not None and existing.proc.poll() is None:
                raise ValueError(f"child {name!r} is already running "
                                 f"(pid {existing.proc.pid})")
            proc = self._launch(name, spec, clean_fault_env=False)
            self.children[name] = ChildRecord(name=name, proc=proc, spec=spec,
                                              respawn=respawn)
        logger.info("agent %s spawned worker %s pid=%d", self.name, name, proc.pid)
        return {"name": name, "pid": proc.pid}

    def stop_child(self, name: str, sig: int = signal.SIGTERM, *,
                   respawn: bool = False) -> dict:
        """Deliver a signal by name. A stop ordered through the agent is
        policy, not failure: auto-respawn is disabled unless asked for."""
        with self._lock:
            child = self.children[name]
            child.respawn = respawn
        try:
            child.proc.send_signal(sig)
        except ProcessLookupError:
            pass
        return {"name": name, "pid": child.proc.pid, "sig": int(sig)}

    def wait_child(self, name: str, timeout_s: float | None = None) -> dict:
        with self._lock:
            child = self.children[name]
        try:
            rc = child.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            rc = None
        return {"name": name, "rc": rc}

    def _watch_loop(self) -> None:
        """Reap children; report exits to the registry; respawn failures."""
        while not self._stop.wait(self.poll_s):
            with self._lock:
                children = list(self.children.values())
            for child in children:
                if child.state == RUNNING and child.proc.poll() is not None:
                    child.last_rc = child.proc.returncode
                    child.state = RESPAWNING if child.respawn else EXITED
                    logger.warning("agent %s: child %s exited rc=%s (%s)",
                                   self.name, child.name, child.last_rc, child.state)
                    if self._registry is not None:
                        try:
                            self._registry.report_exit(child.name, child.last_rc)
                        except Exception as e:
                            logger.warning("report_exit(%s) failed: %s",
                                           child.name, e)
                if child.state == RESPAWNING and time.monotonic() >= child.next_retry:
                    self._try_respawn(child)

    def _try_respawn(self, child: ChildRecord) -> None:
        if child.restarts >= self.max_restarts:
            logger.error("agent %s: child %s exhausted %d restarts",
                         self.name, child.name, self.max_restarts)
            child.state = EXITED
            return
        try:
            # chaos point: a respawn attempt that fails (fork quota, port
            # exhaustion) — the watch loop must retry with backoff, not
            # abandon the node
            faults.fire("agent.respawn")
            proc = self._launch(child.name, child.spec, clean_fault_env=True)
        except Exception as e:
            child.next_retry = time.monotonic() + min(
                2.0, 0.1 * (2 ** min(child.restarts, 4))
            )
            logger.warning("agent %s: respawn of %s failed (%s); will retry",
                           self.name, child.name, e)
            return
        child.proc = proc
        child.restarts += 1
        child.state = RUNNING
        logger.info("agent %s respawned worker %s pid=%d (restart %d)",
                    self.name, child.name, proc.pid, child.restarts)

    # -- wire service ----------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            wire.configure_stream_socket(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="agent-conn", daemon=True).start()

    def _serve_conn(self, conn) -> None:
        with conn:
            reader = wire.FrameReader(conn)
            while not self._stop.is_set():
                try:
                    req = reader.recv_msg()
                except (OSError, wire.WireError):
                    return
                rid = req.get("id") if isinstance(req, dict) else None
                try:
                    result = self._invoke(req.get("svc", ""), req.get("kwargs") or {})
                    resp = {"id": rid, "ok": True, "result": result}
                except faults.DropConnection as e:
                    logger.warning("agent chaos: dropping connection at %s", e)
                    return
                except Exception as e:
                    resp = {"id": rid, "ok": False, "error": f"{type(e).__name__}: {e}",
                            "traceback": traceback.format_exc()}
                try:
                    wire.send_msg(conn, resp)
                except (OSError, wire.WireError):
                    return

    def _invoke(self, svc: str, kwargs: dict) -> Any:
        if svc == "agent/ping":
            with self._lock:
                return {"pid": os.getpid(), "name": self.name,
                        "children": len(self.children)}
        if svc == "agent/spawn":
            return self.spawn(kwargs["name"], kwargs.get("args"),
                              respawn=bool(kwargs.get("respawn", True)))
        if svc == "agent/list":
            with self._lock:
                return [c.to_json() for c in self.children.values()]
        if svc == "agent/stop":
            return self.stop_child(kwargs["name"],
                                   int(kwargs.get("sig", signal.SIGTERM)),
                                   respawn=bool(kwargs.get("respawn", False)))
        if svc == "agent/wait":
            return self.wait_child(kwargs["name"], kwargs.get("timeout_s"))
        if svc == "agent/shutdown":
            threading.Thread(target=self.stop, daemon=True).start()
            return {}
        raise ValueError(f"unknown agent service {svc!r}")


class AgentClient(ServiceClient):
    """Typed ``agent/*`` helpers over :class:`~repro_torch.fabric.registry.ServiceClient`."""

    def ping(self) -> dict:
        return self.request("agent/ping")

    def spawn(self, name: str, args: dict | None = None, *,
              respawn: bool = True) -> dict:
        return self.request("agent/spawn", name=name, args=args or {},
                            respawn=respawn)

    def list_children(self) -> list[dict]:
        return self.request("agent/list")

    def stop_child(self, name: str, sig: int = signal.SIGTERM, *,
                   respawn: bool = False) -> dict:
        return self.request("agent/stop", name=name, sig=int(sig), respawn=respawn)

    def wait_child(self, name: str, timeout_s: float | None = None) -> int | None:
        return self.request("agent/wait", name=name, timeout_s=timeout_s)["rc"]

    def shutdown(self) -> None:
        self.request("agent/shutdown")


# ---------------------------------------------------------------------------
# entrypoint + CI smoke
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.fabric.agent")
    ap.add_argument("--registry", default="", help="registry host:port")
    ap.add_argument("--store", default="", help="shared NBS store root for workers")
    ap.add_argument("--jobstore", default="", help="shared jobstore root")
    ap.add_argument("--name", default="", help="agent name in the registry")
    ap.add_argument("--host", default="127.0.0.1", help="host workers bind on")
    ap.add_argument("--tcp", default="", help="host:port the agent serves on "
                                              "(default: --host with ephemeral port)")
    ap.add_argument("--max-restarts", type=int, default=8)
    ap.add_argument("--worker-heartbeat-s", type=float, default=0.5)
    ap.add_argument("--device", default="cuda",
                    help="device of the workers this agent spawns (cuda or cpu)")
    ap.add_argument("--ready-file", default="", help="write {pid, address} here")
    ap.add_argument("--smoke", action="store_true",
                    help="self-contained registry+agent+worker smoke (CI)")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.smoke:
        return smoke(args.device)
    if not args.store:
        raise SystemExit("agent needs --store (workers share it)")
    faults.set_role("agent", node=args.name or None)
    agent = Agent(
        store_root=args.store,
        registry_addr=tcp_address(args.registry) if args.registry else None,
        jobstore_root=args.jobstore or None,
        name=args.name,
        host=args.host,
        address=tcp_address(args.tcp, default_host=args.host) if args.tcp else None,
        max_restarts=args.max_restarts,
        worker_heartbeat_s=args.worker_heartbeat_s,
        device=args.device,
    ).start()
    if args.ready_file:
        tmp = Path(args.ready_file + ".tmp")
        tmp.write_text(json.dumps({"pid": os.getpid(),
                                   "address": list(agent.address)}))
        os.replace(tmp, args.ready_file)
    stopping = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stopping.set())
    try:
        agent.serve_forever(until=stopping.is_set)
    finally:
        agent.stop()
    return 0


def smoke(device: str = "cuda") -> int:
    """CI smoke: agent-spawned worker is SIGKILLed, respawned at a new port,
    and re-resolved through the registry — end to end over TCP.

    The worker is spawned by an *agent subprocess* (two forks away from this
    process): the harness reaches it only through the registry's pid record,
    which is exactly the multi-host story.
    """
    import shutil
    import tempfile

    from repro_torch.fabric.registry import Registry, RegistryServer

    tmp = Path(tempfile.mkdtemp(prefix="agent-smoke-"))
    registry = Registry(suspect_after_s=0.8, dead_after_s=2.0)
    server = RegistryServer(registry).start()
    reg_spec = f"{server.address[1]}:{server.address[2]}"
    agent_proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.fabric.agent",
         "--registry", reg_spec, "--store", str(tmp / "s3"),
         "--name", "agent0", "--worker-heartbeat-s", "0.25", "--device", device],
        env={**os.environ, "PYTHONPATH": _src_dir()},
    )
    try:
        reg = RegistryClient(server.address)
        agent_rec = reg.wait_state("agent0", "alive", timeout=30)
        with AgentClient(agent_rec["address"]) as agent:
            agent.spawn("W", {"serve_only": True})
            first = reg.wait_state("W", "alive", timeout=60)
            print(f"smoke: W gen={first['generation']} at {first['address']}")

            os.kill(first["pid"], signal.SIGKILL)  # pid known only via registry
            reg.wait_state("W", "dead", timeout=15)
            print("smoke: W reported dead")

            second = reg.wait_state("W", "alive", timeout=60)
            if second["generation"] <= first["generation"]:
                raise AssertionError("respawn did not bump the generation")
            if tuple(second["address"]) == tuple(first["address"]):
                raise AssertionError("respawn reused the old port")
            # re-resolution must land on a live server at the NEW address
            from repro_torch.fabric.proxy import wait_ready

            info = wait_ready(second["address"], timeout=30)
            if info.get("pid") == first["pid"]:
                raise AssertionError("re-resolved ping answered by the corpse")
            print(f"smoke: W respawned gen={second['generation']} at "
                  f"{second['address']} (pid {info['pid']}) — re-resolution ok")
            agent.shutdown()
        agent_proc.wait(timeout=30)
        return 0
    finally:
        if agent_proc.poll() is None:
            agent_proc.kill()
            agent_proc.wait(timeout=10)
        server.stop()
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
