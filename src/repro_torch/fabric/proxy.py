"""Client side of the fabric: FabricClient + the RemoteNode proxy.

``RemoteNode`` subclasses :class:`~repro_torch.core.nbs.Node` and overrides
``invoke`` so ``nbs.call(dest, svc, **kwargs)`` transparently crosses the
process boundary. Store-mediated hops work unchanged — the CMI travels
through the shared store; only the *request* ("restore hops/<name> onto your
device") rides the socket. ``svc/hop`` against a remote node therefore returns
a :class:`RemoteStateRef` receipt instead of live state: the state is now
resident in the worker process, which is the entire point of navigating the
computation to the data.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any

from repro_torch.chaos import faults
from repro_torch.core.nbs import Node, RemoteStateRef  # noqa: F401  (re-export)
from repro_torch.fabric import wire
from repro_torch.utils import logger


class FabricClient:
    """One connection to a NodeServer; thread-safe request/response.

    A dead connection (worker SIGKILLed, then respawned at the same address)
    is re-established transparently: one reconnect attempt per request, with
    a short window to cover a replacement worker re-binding the address.
    This is what lets a streaming hop's *fallback* store-mediated request
    land on the respawned instance instead of dying with the old one.

    Only idempotent services are re-sent (the connection may have died
    AFTER the server executed the request): re-leasing, re-dropping a token,
    or re-restoring a hop CMI (the server dedups on the CMI name and returns
    the original receipt, since the transit CMI is GC'd after the first
    restore) converge to the same end state, but ``svc/fetch`` (drop side
    effect), ``svc/run_stage`` (reruns the stage), ``svc/relay`` (re-streams)
    and ``svc/publish_job`` (status transitions) must surface the transport
    error instead of executing twice.

    ``on_reconnect`` (set by :class:`RemoteNode`) fires after every
    successful re-establishment: the server may be a fresh incarnation, so
    anything cached against its resident state must be invalidated.

    ``resolver`` (optional, no arguments -> fresh address or None) is the
    registry hook: it is consulted before every reconnect attempt, so a
    worker respawned at a NEW ephemeral port is re-resolved transparently —
    the proxy follows the *name*, not the corpse's address.
    """

    _RETRY_SAFE = frozenset({
        "svc/ping", "svc/hop", "svc/drop", "svc/list_jobs", "svc/get_job",
        "svc/renew_lease", "svc/shutdown",
    })

    def __init__(self, address, *, reconnect_timeout_s: float = 10.0,
                 connect_timeout_s: float = wire.DEFAULT_CONNECT_TIMEOUT_S,
                 resolver=None):
        self.address = tuple(address)
        self.reconnect_timeout_s = reconnect_timeout_s
        self.connect_timeout_s = connect_timeout_s
        self.resolver = resolver  # callable() -> address | None
        self.on_reconnect = None  # callable | None
        self._sock = wire.connect(self.address, timeout=connect_timeout_s)
        self._reader = wire.FrameReader(self._sock)
        self._lock = threading.Lock()
        self._next_id = 0

    def _re_resolve(self) -> None:
        if self.resolver is None:
            return
        try:
            fresh = self.resolver()
        except Exception as e:
            logger.warning("resolver for %s failed: %s", self.address, e)
            return
        if fresh and tuple(fresh) != self.address:
            logger.info("fabric address re-resolved: %s -> %s",
                        self.address, tuple(fresh))
            self.address = tuple(fresh)

    def _reconnect(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        # bounded exponential backoff with jitter under one overall deadline:
        # early attempts race a respawn-in-place, later ones wait out an
        # agent respawn + re-registration without hammering the host
        deadline = time.monotonic() + self.reconnect_timeout_s
        delay = 0.05
        while True:
            self._re_resolve()
            try:
                self._sock = wire.connect(
                    self.address,
                    timeout=min(self.connect_timeout_s,
                                max(0.1, deadline - time.monotonic())),
                )
                self._reader = wire.FrameReader(self._sock)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(min(delay * wire._jitter.uniform(0.5, 1.0),
                               max(0.0, deadline - time.monotonic())))
                delay = min(delay * 2.0, 1.0)
        if self.on_reconnect is not None:
            self.on_reconnect()

    def request(self, svc: str, **kwargs) -> Any:
        # svc/get_job is only idempotent when it names a job (re-leasing the
        # same job to the same worker converges); the claim-NEXT form would
        # lease a second job on resend, stranding the first under a dead
        # heartbeat-less lease
        retry_safe = svc in self._RETRY_SAFE and not (
            svc == "svc/get_job" and kwargs.get("job_id") is None
        )
        with self._lock:
            self._next_id += 1
            rid = self._next_id
            for attempt in (0, 1):
                try:
                    # chaos point: a kill_conn here exercises exactly the
                    # reconnect-resend (retry-safe) machinery below
                    faults.fire("proxy.request", sock=self._sock)
                    wire.send_msg(self._sock, {"id": rid, "svc": svc, "kwargs": kwargs})
                    resp = self._reader.recv_msg()
                    break
                except (OSError, wire.WireError):
                    if attempt or not retry_safe:
                        raise
                    logger.warning(
                        "fabric connection to %s lost during %s; reconnecting",
                        self.address, svc,
                    )
                    self._reconnect()
        if not isinstance(resp, dict) or resp.get("id") != rid:
            raise wire.WireError(f"out-of-order response: {resp!r}")
        if resp.get("ok"):
            return resp.get("result")
        raise wire.RemoteError(resp.get("error", "remote failure"), resp.get("traceback", ""))

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def wait_ready(address, timeout: float = 120.0, poll_s: float = 0.1) -> dict:
    """Poll svc/ping until the server answers. A torch worker's start-up is
    its ``import torch`` plus, on the card, the CUDA context it creates
    before it serves — seconds, more on a busy host."""
    deadline = time.monotonic() + timeout
    last: Exception | None = None
    while time.monotonic() < deadline:
        try:
            with FabricClient(address) as c:
                return c.request("svc/ping")
        except (OSError, wire.WireError) as e:
            last = e
            time.sleep(poll_s)
    raise TimeoutError(f"no fabric server at {address} after {timeout}s: {last}")


@dataclass
class RemoteNode(Node):
    """A Node whose services live in another process."""

    client: FabricClient | None = None
    _hop_wrap: bool = field(default=True, repr=False)
    # (token, {(path, bslice_key): hash}) from the last streamed hop to this
    # node — the delta baseline for the next one. None until a stream lands.
    _stream_baseline: tuple[str, dict] | None = field(default=None, repr=False)
    # full receipt of the last stream into this node — a hop_stream from
    # this process or a worker's relay ({chunks, data_chunks, ref_chunks,
    # sent_bytes, ...}) — benches/tests read the delta accounting
    last_stream_receipt: dict | None = field(default=None, repr=False)
    # counters of the last streamed fetch from this node, as the receiver
    # here counted them ({chunks, data_chunks, bytes})
    last_fetch_receipt: dict | None = field(default=None, repr=False)
    # test hook: ask the receiver to abort after N chunks (fault injection)
    _stream_fail_after: int | None = field(default=None, repr=False)

    supports_hop_stream = True
    supports_fetch_stream = True

    @classmethod
    def connect(cls, name: str, address, *, meta: dict | None = None,
                resolver=None) -> "RemoteNode":
        client = FabricClient(address, resolver=resolver)
        info = client.request("svc/ping")
        node = cls(name=name, device=None,
                   meta={**(meta or {}), "pid": info.get("pid"), "device": info.get("device")},
                   client=client)
        # a reconnect means a possibly-fresh worker incarnation: any resident
        # state this proxy knows about (delta baselines) is gone over there
        client.on_reconnect = node._invalidate_stream_state
        logger.info("connected remote node %s at %s (pid %s)", name, tuple(address),
                    info.get("pid"))
        return node

    def _invalidate_stream_state(self) -> None:
        if self._stream_baseline is not None or self.last_stream_receipt is not None:
            logger.info("remote node %s: dropping cached stream baseline", self.name)
        self._stream_baseline = None
        self.last_stream_receipt = None

    def invoke(self, svc_name: str, /, **kwargs) -> Any:
        if self.client is None:
            raise RuntimeError(f"remote node {self.name!r} is not connected")
        result = self.client.request(svc_name, **kwargs)
        if self._hop_wrap and svc_name == "svc/hop" and isinstance(result, dict) \
                and "token" in result:
            return RemoteStateRef(
                node=result.get("node", self.name),
                token=result["token"],
                step=int(result.get("step", 0)),
                leaves=int(result.get("leaves", 0)),
            )
        return result

    def hop_stream(
        self,
        state: Any,
        *,
        step: int = 0,
        chunk_bytes: int = 16 << 20,
        changed_hint: dict | None = None,
        src: str = "?",
    ) -> RemoteStateRef:
        """Stream ``state`` directly to this node's process (paper §Q5).

        Opens a dedicated socket (the control connection stays clean for
        concurrent calls), pipelines chunk frames, and returns the resident
        receipt. When a previous streamed hop to this node is still resident,
        only changed chunks travel (delta against the cached baseline).
        Raises ``repro_torch.fabric.stream.StreamHopError`` on any failure — the
        caller (``dhp.hop``) falls back to the store-mediated path.

        Receipts are OWNING handles: each hop lands a full resident copy in
        the worker, and nothing is dropped implicitly (several receipts per
        node is a legitimate state — MobilePipeline keeps one per in-flight
        item). A loop that repeatedly hops fresh states to one node must
        retire superseded receipts via ``svc/drop``/``svc/fetch`` or the
        worker's memory grows by one state per hop.
        """
        from repro_torch.fabric.stream import send_state_stream

        if self.client is None:
            raise RuntimeError(f"remote node {self.name!r} is not connected")
        baseline_token, baseline_grid = self._stream_baseline or (None, None)
        try:
            receipt, sent_grid = send_state_stream(
                self.client.address,
                state,
                src=src,
                step=step,
                chunk_bytes=chunk_bytes,
                baseline_token=baseline_token,
                baseline_grid=baseline_grid,
                changed_hint=changed_hint,
                **({"fail_after_chunks": self._stream_fail_after}
                   if self._stream_fail_after is not None else {}),
            )
        except Exception:
            # the receiver's end state is unknowable after a failed stream
            # (and the caller's fallback lands state under a NEW token): a
            # later delta must never negotiate against this stale baseline
            self._invalidate_stream_state()
            raise
        self._stream_baseline = (receipt["token"], sent_grid)
        self.last_stream_receipt = receipt
        return RemoteStateRef(
            node=receipt.get("node", self.name),
            token=receipt["token"],
            step=int(receipt.get("step", 0)),
            leaves=int(receipt.get("leaves", 0)),
            via="stream",
        )

    def fetch_stream(self, token: str, *, drop: bool = True,
                     chunk_bytes: int = 16 << 20, device=None) -> tuple[Any, int]:
        """Stream a resident state BACK from this node — the return leg of a
        remote tour (no store in the path). Returns ``(state, step)``, its
        tensors on ``device`` (``None``: the card, raising where there is
        none); the session's counters (``chunks``, ``data_chunks``,
        ``bytes`` received) are kept in ``last_fetch_receipt``.

        Raises ``StreamHopError`` on failure; the resident copy survives on
        the worker unless the final ack round-trip completed, so the caller
        (``dhp.fetch``) can fall back to the store-mediated ``svc/fetch``.
        """
        from repro_torch.fabric.stream import fetch_state_stream

        if self.client is None:
            raise RuntimeError(f"remote node {self.name!r} is not connected")
        state, step, self.last_fetch_receipt = fetch_state_stream(
            self.client.address, token, drop=drop, chunk_bytes=chunk_bytes, device=device)
        return state, step

    def close(self) -> None:
        if self.client is not None:
            self.client.close()
            self.client = None
