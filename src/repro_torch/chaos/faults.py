"""Protocol-state fault injection for the NavP fabric.

The fabric modules (wire/server/stream/proxy/dhp/jobstore/atomic) call
:func:`fire` at named protocol states — ``"hop_stream.mid_stream"``,
``"publish.before_commit"``, ``"lease.before_renew"``, … (the full list
lives in ``docs/fabric.md`` § "Chaos matrix"). With no plan armed the call
is a single dict lookup; with one armed, the matching fault executes *at
that state*:

    kill_conn   close the socket (when one is in scope) and raise a
                ConnectionError; server-side without a socket, raise
                :class:`DropConnection`, which NodeServer catches to drop
                the connection without replying — the client sees a peer
                death exactly at that protocol state
    sigkill     os.kill(self, SIGKILL) — the no-notice spot reclaim, landing
                precisely mid-protocol instead of "sometime during the job"
    delay       sleep ``delay_s`` (races / timeout windows)
    garble      flip one byte of the frame payload about to be sent — the
                receiver's crc32 must catch it
    error       raise :class:`FaultInjected` (a generic service failure)

Plans travel in the ``REPRO_FAULT_PLAN`` env var as JSON so worker
*processes* honor them too (FabricSupervisor copies os.environ into child
env). Each fault spec is a dict::

    {"point": "hop_stream.mid_stream",  # required: the state to strike at
     "action": "kill_conn",             # required: one of the above
     "after": 0,                        # skip the first N hits of the point
     "times": 1,                        # strike at most N times (default 1)
     "delay_s": 0.05,                   # for action=delay
     "role": "worker",                  # only in processes with this role
     "node": "W2"}                      # only in the process serving node W2

``role``/``node`` scoping is what keeps a ``sigkill`` plan from shooting
the driver/test process: workers call :func:`set_role` at startup, the
driver's role defaults to ``"driver"``.

Hit counters are per-process and reset whenever the env value changes, so
``arm(...)`` blocks compose sequentially within one process.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import threading
import time

ENV_VAR = "REPRO_FAULT_PLAN"

_lock = threading.Lock()
_role = "driver"
_node: str | None = None
# cache: (env string) -> FaultPlan, with per-point hit counters living on
# the plan object so they reset when the plan changes
_cached_env: str | None = None
_cached_plan: "FaultPlan | None" = None


class FaultInjected(RuntimeError):
    """A generic injected service failure."""


class DropConnection(Exception):
    """Server-side kill_conn: drop the connection without replying."""


def set_role(role: str, node: str | None = None) -> None:
    """Declare what this process is (worker entrypoints call this)."""
    global _role, _node
    _role, _node = role, node


class FaultPlan:
    """A parsed list of fault specs with per-point hit counters."""

    def __init__(self, specs: list[dict]):
        self.specs = specs
        self.counts: dict[int, int] = {}  # spec index -> hits matched so far
        self.fired: dict[int, int] = {}  # spec index -> strikes executed

    @staticmethod
    def from_env(value: str) -> "FaultPlan":
        specs = json.loads(value)
        if isinstance(specs, dict):
            specs = [specs]
        return FaultPlan([dict(s) for s in specs])

    def match(self, point: str) -> dict | None:
        """Return the spec to execute at ``point`` now, advancing counters."""
        for i, spec in enumerate(self.specs):
            if spec.get("point") != point:
                continue
            role = spec.get("role")
            if role is not None and role != _role:
                continue
            node = spec.get("node")
            if node is not None and node != _node:
                continue
            n = self.counts.get(i, 0)
            self.counts[i] = n + 1
            if n < int(spec.get("after", 0)):
                continue
            if self.fired.get(i, 0) >= int(spec.get("times", 1)):
                continue
            self.fired[i] = self.fired.get(i, 0) + 1
            return spec
        return None


def _current_plan() -> FaultPlan | None:
    global _cached_env, _cached_plan
    value = os.environ.get(ENV_VAR)
    if value == _cached_env:
        return _cached_plan
    with _lock:
        if value != _cached_env:
            _cached_plan = FaultPlan.from_env(value) if value else None
            _cached_env = value
    return _cached_plan


def fire(point: str, *, sock=None, data=None):
    """Consult the armed plan at protocol state ``point``.

    ``sock`` (when the caller holds one) lets ``kill_conn`` close it before
    raising. ``data`` is a mutable buffer (bytearray/memoryview) about to hit
    the wire; ``garble`` flips a byte in place. Returns ``data`` (possibly
    garbled) for convenience.
    """
    plan = _current_plan()
    if plan is None:
        return data
    with _lock:
        spec = plan.match(point)
    if spec is None:
        return data
    action = spec.get("action", "error")
    if action == "delay":
        time.sleep(float(spec.get("delay_s", 0.05)))
        return data
    if action == "garble":
        if data is None:
            return data
        buf = bytearray(data)  # payloads arrive as bytes/memoryview
        if buf:
            buf[0] ^= 0xFF
        return buf
    if action == "sigkill":
        os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(60)  # unreachable; SIGKILL is not deliverable mid-bytecode
    if action == "kill_conn":
        if sock is not None:
            with contextlib.suppress(OSError):
                sock.close()
            raise ConnectionError(f"fault injection: connection killed at {point}")
        raise DropConnection(point)
    raise FaultInjected(f"injected failure at {point}")


def _invalidate_cache() -> None:
    global _cached_env, _cached_plan
    with _lock:
        _cached_env = None
        _cached_plan = None


@contextlib.contextmanager
def arm(*specs: dict):
    """Arm fault specs for the current process tree (sets the env var, so
    workers spawned inside the block inherit the plan). Each ``arm`` starts
    with fresh counters even when the specs are identical to the last plan
    (the value-keyed cache alone would keep spent counters alive).

    Dotted points are validated against :data:`repro_torch.chaos.sites.SITES` —
    arming ``"hop_stream.midstream"`` (typo) raises instead of silently
    never firing. Single-token points stay unvalidated for unit tests.
    """
    from repro_torch.chaos.sites import SITES, is_known

    for spec in specs:
        point = spec.get("point")
        if isinstance(point, str) and not is_known(point):
            raise ValueError(
                f"unknown fault point {point!r}; registered points live in "
                f"repro_torch.chaos.sites.SITES ({len(SITES)} entries)"
            )
    old = os.environ.get(ENV_VAR)
    os.environ[ENV_VAR] = json.dumps(list(specs))
    _invalidate_cache()
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(ENV_VAR, None)
        else:
            os.environ[ENV_VAR] = old
        _invalidate_cache()
