"""Node registry: name -> (host, port) resolution with heartbeat liveness.

This is the piece that turns the process fabric into a *multi-host* fabric
(Cao et al.'s "checkpointing as a service" separation: a coordinator that
registers and monitors hosts it does not own). Workers register themselves
at startup — ``name -> ("tcp", host, port)`` plus pid and kind — and
heartbeat on an interval; the registry's monitor drives a per-node state
machine off the observed heartbeat gap::

    ALIVE --(gap > suspect_after_s)--> SUSPECT --(gap > dead_after_s)--> DEAD
      ^                                   |                               |
      +------------- heartbeat / re-registration (new generation) -------+

Every transition invokes ``on_state_change(name, old, new, record)`` — the
supervisor hangs lease release and respawn policy off these callbacks.

Re-registration bumps the record's **generation** and replaces the address:
a respawned worker at a new ephemeral port is a *new incarnation* of the
same name. Drivers resolve names through :func:`node_resolver`, which
``FabricClient`` consults on reconnect — so a proxy whose connection died
re-resolves to the fresh incarnation instead of retrying a corpse. A zombie
predecessor still heartbeating with a stale generation is ignored.

Served over the existing length-prefixed wire (same ``{id, svc, kwargs}`` /
``{id, ok, result}`` frames as :class:`~repro_torch.fabric.server.NodeServer`),
services ``reg/*``. The module touches no device, so the per-host agent
(:mod:`repro_torch.fabric.agent`) stays a lightweight process.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

from repro_torch.chaos import faults
from repro_torch.fabric import wire
from repro_torch.utils import logger

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"


def tcp_address(spec: str, *, default_host: str = "127.0.0.1") -> tuple:
    """Parse a ``host:port`` CLI spec into a ``("tcp", host, port)`` address."""
    host, _, port = spec.rpartition(":")
    return ("tcp", host or default_host, int(port or 0))


def _as_address(value) -> tuple:
    """Normalize a wire-decoded address (lists arrive from JSON/msgpack)."""
    value = tuple(value)
    if value[0] == "tcp":
        return ("tcp", value[1], int(value[2]))
    return value


@dataclass
class NodeRecord:
    name: str
    address: tuple
    pid: int = 0
    kind: str = "worker"  # "worker" | "agent"
    meta: dict = field(default_factory=dict)
    generation: int = 1
    state: str = ALIVE
    last_heartbeat: float = 0.0  # time.monotonic() of the last sign of life
    exit_rc: int | None = None  # agent-reported exit code, when it saw one

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "address": list(self.address),
            "pid": self.pid,
            "kind": self.kind,
            "meta": dict(self.meta),
            "generation": self.generation,
            "state": self.state,
            "exit_rc": self.exit_rc,
        }


class Registry:
    """The node table + heartbeat-gap state machine (transport-free core).

    Thread-safe; callbacks run outside the lock (they may re-enter the
    registry — e.g. a DEAD callback that asks an agent to respawn, whose
    worker then re-registers from another thread).
    """

    def __init__(
        self,
        *,
        suspect_after_s: float = 1.5,
        dead_after_s: float = 4.0,
        on_state_change: Callable[[str, str, str, NodeRecord], None] | None = None,
    ):
        if dead_after_s <= suspect_after_s:
            raise ValueError("dead_after_s must exceed suspect_after_s")
        self.suspect_after_s = suspect_after_s
        self.dead_after_s = dead_after_s
        self.on_state_change = on_state_change
        self.records: dict[str, NodeRecord] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._monitor: threading.Thread | None = None

    # -- registration / heartbeats ------------------------------------------
    def register(self, name: str, address, *, pid: int = 0, kind: str = "worker",
                 meta: dict | None = None) -> int:
        """(Re-)register ``name``; returns the new generation number.

        Re-registration is how a respawn announces itself: the generation
        bumps, the address is replaced, and the record snaps back to ALIVE —
        which is exactly the cache invalidation drivers key off.
        """
        events = []
        with self._lock:
            prev = self.records.get(name)
            generation = (prev.generation + 1) if prev is not None else 1
            rec = NodeRecord(
                name=name, address=_as_address(address), pid=int(pid), kind=kind,
                meta=dict(meta or {}), generation=generation,
                last_heartbeat=time.monotonic(),
            )
            self.records[name] = rec
            if prev is not None and prev.state != ALIVE:
                events.append((name, prev.state, ALIVE, rec))
        logger.info("registry: %s gen=%d at %s (pid %s)", name, generation,
                    rec.address, pid or "?")
        self._emit(events)
        return generation

    def heartbeat(self, name: str, generation: int | None = None) -> str:
        """Record a sign of life; returns the record's state after it.

        A stale-generation heartbeat (zombie predecessor outliving its
        replacement) is ignored and answered ``"stale"`` — the zombie's
        beats must not keep the NEW incarnation's record alive.
        """
        events = []
        with self._lock:
            rec = self.records.get(name)
            if rec is None:
                return "unknown"
            if generation is not None and int(generation) != rec.generation:
                return "stale"
            rec.last_heartbeat = time.monotonic()
            if rec.state != ALIVE:
                events.append((name, rec.state, ALIVE, rec))
                rec.state = ALIVE
                rec.exit_rc = None
            state = rec.state
        self._emit(events)
        return state

    def report_exit(self, name: str, rc: int | None = None) -> None:
        """An agent watched the process die: mark DEAD *now*, ahead of the
        heartbeat timeout — exit codes beat gap inference when available."""
        events = []
        with self._lock:
            rec = self.records.get(name)
            if rec is None:
                return
            rec.exit_rc = rc
            if rec.state != DEAD:
                events.append((name, rec.state, DEAD, rec))
                rec.state = DEAD
        self._emit(events)

    def resolve(self, name: str) -> NodeRecord:
        with self._lock:
            rec = self.records.get(name)
            if rec is None:
                raise KeyError(f"unknown node {name!r}")
            return rec

    def deregister(self, name: str) -> None:
        with self._lock:
            self.records.pop(name, None)

    def list_nodes(self) -> list[NodeRecord]:
        with self._lock:
            return list(self.records.values())

    # -- the state machine ----------------------------------------------------
    def sweep(self, now: float | None = None) -> None:
        """One monitor pass: advance states off observed heartbeat gaps."""
        now = time.monotonic() if now is None else now
        events = []
        with self._lock:
            for rec in self.records.values():
                gap = now - rec.last_heartbeat
                if rec.state == ALIVE and gap > self.suspect_after_s:
                    events.append((rec.name, rec.state, SUSPECT, rec))
                    rec.state = SUSPECT
                if rec.state == SUSPECT and gap > self.dead_after_s:
                    events.append((rec.name, rec.state, DEAD, rec))
                    rec.state = DEAD
        self._emit(events)

    def _emit(self, events) -> None:
        for name, old, new, rec in events:
            logger.log(
                30 if new == DEAD else 20,
                "registry: %s %s -> %s (gen %d)", name, old, new, rec.generation,
            )
            if self.on_state_change is not None:
                try:
                    self.on_state_change(name, old, new, rec)
                except Exception:
                    logger.exception("registry state-change callback failed")

    def start(self) -> "Registry":
        """Run the monitor thread (sweeps at a fraction of suspect_after_s)."""
        self._stop.clear()
        poll = max(0.05, self.suspect_after_s / 4.0)

        def monitor() -> None:
            while not self._stop.wait(poll):
                self.sweep()

        self._monitor = threading.Thread(target=monitor, name="registry-monitor",
                                         daemon=True)
        self._monitor.start()
        return self

    def stop(self) -> None:
        self._stop.set()


# ---------------------------------------------------------------------------
# wire service
# ---------------------------------------------------------------------------


class RegistryServer:
    """Serve a :class:`Registry` over the fabric wire (``reg/*`` services)."""

    def __init__(self, registry: Registry, address=("tcp", "127.0.0.1", 0)):
        self.registry = registry
        self._listener, self.address = wire.listen(address)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "RegistryServer":
        self.registry.start()
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="registry-accept", daemon=True)
        self._thread.start()
        logger.info("registry serving on %s", self.address)
        return self

    def stop(self) -> None:
        self._stop.set()
        self.registry.stop()
        try:
            self._listener.close()
        except OSError:
            pass
        if self.address[0] == "unix":
            try:
                os.unlink(self.address[1])
            except OSError:
                pass

    def serve_forever(self, poll_s: float = 0.2, until=None) -> None:
        while not self._stop.wait(poll_s):
            if until is not None and until():
                return

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            wire.configure_stream_socket(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="registry-conn", daemon=True).start()

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
                    logger.warning("registry chaos: dropping connection at %s", e)
                    return
                except Exception as e:
                    resp = {"id": rid, "ok": False, "error": f"{type(e).__name__}: {e}",
                            "traceback": traceback.format_exc()}
                try:
                    wire.send_msg(conn, resp)
                except (OSError, wire.WireError):
                    return

    def _invoke(self, svc: str, kwargs: dict) -> Any:
        reg = self.registry
        if svc == "reg/ping":
            return {"pid": os.getpid(), "nodes": len(reg.records)}
        if svc == "reg/register":
            generation = reg.register(
                kwargs["name"], kwargs["address"], pid=int(kwargs.get("pid", 0)),
                kind=kwargs.get("kind", "worker"), meta=kwargs.get("meta"),
            )
            return {"generation": generation}
        if svc == "reg/heartbeat":
            return {"state": reg.heartbeat(kwargs["name"], kwargs.get("generation"))}
        if svc == "reg/resolve":
            return reg.resolve(kwargs["name"]).to_json()
        if svc == "reg/list":
            return [rec.to_json() for rec in reg.list_nodes()]
        if svc == "reg/report_exit":
            reg.report_exit(kwargs["name"], kwargs.get("rc"))
            return {}
        if svc == "reg/deregister":
            reg.deregister(kwargs["name"])
            return {}
        if svc == "reg/shutdown":
            threading.Thread(target=self.stop, daemon=True).start()
            return {}
        raise ValueError(f"unknown registry service {svc!r}")


class ServiceClient:
    """Minimal ``{id, svc, kwargs}`` wire client with blind reconnect-resend.

    Deliberately not :class:`~repro_torch.fabric.proxy.FabricClient`: it is only
    safe for *idempotent* service surfaces (every ``reg/*`` and ``agent/*``
    service converges on resend), and keeping the import graph wire-only
    lets the per-host agent use it without the proxy stack.
    """

    def __init__(self, address, *, connect_timeout_s: float = 3.0,
                 connect_attempts: int = 3):
        self.address = _as_address(address)
        self.connect_timeout_s = connect_timeout_s
        self.connect_attempts = connect_attempts
        self._sock = None
        self._reader: wire.FrameReader | None = None
        self._lock = threading.Lock()
        self._next_id = 0

    def _ensure(self) -> None:
        if self._sock is None:
            self._sock = wire.connect(self.address, timeout=self.connect_timeout_s,
                                      attempts=self.connect_attempts)
            self._reader = wire.FrameReader(self._sock)

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._reader = None

    def request(self, svc: str, **kwargs) -> Any:
        with self._lock:
            self._next_id += 1
            rid = self._next_id
            for attempt in (0, 1):
                try:
                    self._ensure()
                    wire.send_msg(self._sock, {"id": rid, "svc": svc, "kwargs": kwargs})
                    resp = self._reader.recv_msg()
                    break
                except (OSError, wire.WireError):
                    self._drop()
                    if attempt:
                        raise
        if not isinstance(resp, dict) or resp.get("id") != rid:
            raise wire.WireError(f"out-of-order registry response: {resp!r}")
        if resp.get("ok"):
            return resp.get("result")
        raise wire.RemoteError(resp.get("error", "remote service failure"),
                               resp.get("traceback", ""))

    def close(self) -> None:
        with self._lock:
            self._drop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class RegistryClient(ServiceClient):
    """Typed ``reg/*`` helpers over :class:`ServiceClient`."""

    def register(self, name: str, address, *, pid: int = 0, kind: str = "worker",
                 meta: dict | None = None) -> int:
        return int(self.request("reg/register", name=name, address=list(address),
                                pid=pid, kind=kind, meta=meta or {})["generation"])

    def heartbeat(self, name: str, generation: int | None = None) -> str:
        return self.request("reg/heartbeat", name=name, generation=generation)["state"]

    def resolve(self, name: str) -> dict:
        # chaos point: a resolve that fails (registry unreachable, transient
        # error) must degrade to the caller's cached address + retry, never
        # crash a reconnect in progress
        faults.fire("registry.resolve")
        rec = self.request("reg/resolve", name=name)
        rec["address"] = _as_address(rec["address"])
        return rec

    def list_nodes(self) -> list[dict]:
        records = self.request("reg/list")
        for rec in records:
            rec["address"] = _as_address(rec["address"])
        return records

    def report_exit(self, name: str, rc: int | None = None) -> None:
        self.request("reg/report_exit", name=name, rc=rc)

    def deregister(self, name: str) -> None:
        self.request("reg/deregister", name=name)

    def wait_state(self, name: str, states, timeout: float = 10.0,
                   poll_s: float = 0.05) -> dict:
        """Poll until ``name``'s state is in ``states`` (test/CI helper)."""
        states = {states} if isinstance(states, str) else set(states)
        deadline = time.monotonic() + timeout
        last = None
        while time.monotonic() < deadline:
            try:
                last = self.resolve(name)
                if last["state"] in states:
                    return last
            except Exception:
                # poll-until helper: unknown name, transport failure, or an
                # injected resolve fault — all read as "not there yet"
                pass
            time.sleep(poll_s)
        raise TimeoutError(f"node {name!r} never reached {sorted(states)} "
                           f"(last: {last and last.get('state')!r})")

    def start_heartbeat(self, name: str, generation: int,
                        interval_s: float = 1.0) -> threading.Event:
        """Beat ``name``'s heart until the returned Event is set.

        Failures are logged and the loop keeps beating — a transient
        registry outage must read as a heartbeat *gap* (SUSPECT, then ALIVE
        again on the next successful beat), not as worker death.
        """
        stop = threading.Event()

        def beat() -> None:
            while not stop.wait(interval_s):
                try:
                    # chaos point: a delay/error here opens a heartbeat gap
                    # without touching the process — the SUSPECT path; a
                    # sigkill here is a worker dying between beats
                    faults.fire("registry.heartbeat_gap")
                    state = self.heartbeat(name, generation)
                    if state == "stale":
                        logger.warning(
                            "heartbeat for %s gen %d is stale (superseded); stopping",
                            name, generation,
                        )
                        return
                except Exception as e:
                    logger.warning("registry heartbeat for %s failed: %s", name, e)

        threading.Thread(target=beat, name=f"registry-heartbeat-{name}",
                         daemon=True).start()
        return stop


def node_resolver(registry: RegistryClient, name: str):
    """A ``FabricClient.resolver`` that re-resolves ``name`` via the registry.

    Returns the freshest registered address (None when the lookup fails —
    the client then retries its cached address). State is deliberately NOT
    filtered: during the SUSPECT window the old address is all there is, and
    once the respawn re-registers, the new address wins by generation.
    """

    def _resolve():
        try:
            return registry.resolve(name)["address"]
        except Exception as e:
            logger.warning("registry resolve of %s failed: %s", name, e)
            return None

    return _resolve


# ---------------------------------------------------------------------------
# entrypoint: python -m repro_torch.fabric.registry
# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.fabric.registry")
    ap.add_argument("--tcp", default="127.0.0.1:0", help="host:port to serve on")
    ap.add_argument("--suspect-after-s", type=float, default=1.5)
    ap.add_argument("--dead-after-s", type=float, default=4.0)
    ap.add_argument("--ready-file", default="", help="write {pid, address} here")
    args = ap.parse_args(argv)

    server = RegistryServer(
        Registry(suspect_after_s=args.suspect_after_s, dead_after_s=args.dead_after_s),
        tcp_address(args.tcp),
    ).start()
    if args.ready_file:
        tmp = Path(args.ready_file + ".tmp")
        tmp.write_text(json.dumps({"pid": os.getpid(),
                                   "address": list(server.address)}))
        os.replace(tmp, args.ready_file)
    stopping = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stopping.set())
    try:
        server.serve_forever(until=stopping.is_set)
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
