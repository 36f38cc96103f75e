"""NodeServer: serves one NBS node's services over a socket.

This is the "fronting them with RPC is mechanical" promise from
``core/nbs.py`` and ``core/jobstore.py`` made real. A worker process builds a
single-node :class:`~repro_torch.core.nbs.NBS` (whose store root is the *shared*
filesystem — the S3 analogue) plus an optional :class:`JobStore`, then serves
the JAX package's services (``repro/fabric/server.py``) over the same wire,
so drivers of either package can call it:

    svc/ping          liveness + identity (pid, resident-state count, and
                      the node's torch ``device`` — a key JAX clients ignore)
    svc/hop           restore a CMI from the shared store onto this node;
                      the live state becomes *resident* here and the caller
                      gets a receipt {token, step, leaves} — bulk data never
                      crosses the control wire (Fig. 3: the CMI moved through
                      the store)
    svc/hop_stream    the streaming transport (paper §Q5): the state arrives
                      as bulk frames on THIS connection, assembled chunk by
                      chunk (``repro_torch.fabric.stream``), and becomes resident
                      without ever touching the disk; its chunk-hash grid is
                      cached so a later hop can delta against it; the
                      assembled tensors are moved onto the node's device,
                      so a stage run on them there runs the card's kernels
    svc/fetch         re-publish a resident state into the store as a fresh
                      CMI so another node can hop it onward
    svc/fetch_stream  the reverse of svc/hop_stream: pump a resident state's
                      chunks back down the requesting connection (the driver
                      gets the tour's final product without a store write);
                      the resident copy is dropped only after the client
                      acks full assembly
    svc/run_stage     run a stage function (addressed by module-qualified
                      name, or a name pre-registered via register_stage) on
                      a resident state — the remote-itinerary compute step;
                      the result becomes resident under a fresh token
    svc/relay         worker-initiated hop: stream a resident state straight
                      to ANOTHER worker's svc/hop_stream (per-destination
                      baseline grids make repeat relays delta); neither the
                      driver nor the disk is in the data path
    svc/publish_resident  save a resident state as a committed CMI at a
                      caller-named store path (the disk-durable mid-tour
                      publish) without dropping the resident copy
    svc/drop          discard a resident state
    svc/renew_lease   heartbeat: extend the caller's jobstore lease
    svc/list_jobs     ┐
    svc/get_job       ├ the paper's three job services (§3.3), job records
    svc/publish_job   ┘ as plain JSON dicts
    svc/shutdown      stop serving (graceful supervisor path)

Requests are ``{"id": n, "svc": name, "kwargs": {...}}``; responses
``{"id": n, "ok": true, "result": ...}`` or ``{"id": n, "ok": false,
"error": msg, "traceback": text}``. One thread per connection — fabric
fan-in is a handful of peers, not a web tier.
"""

from __future__ import annotations

import importlib
import os
import threading
import time
import traceback
import uuid
from pathlib import Path
from typing import Any, Callable

from repro_torch.chaos import faults
from repro_torch.core.jobstore import JobStore
from repro_torch.core.nbs import NBS
from repro_torch.fabric import stream, wire
from repro_torch.utils import flatten_with_paths, logger

# Stage functions addressable by a short name instead of a module path —
# a worker entrypoint can pre-register application stages here before
# serving. Module-qualified references ("pkg.mod:qualname") need no
# registration: any function importable inside the worker resolves.
STAGE_REGISTRY: dict[str, Callable] = {}


def register_stage(name: str, fn: Callable) -> None:
    STAGE_REGISTRY[name] = fn


def registered_stages() -> list[str]:
    """Stage names addressable by short name in THIS worker process.

    Exposed through ``svc/ping`` so drivers (and navlint's runtime half,
    ``itinerary.validate_stages``) can check a ``Stage.fn_ref`` against
    what the worker actually registered instead of discovering a
    ``StageResolutionError`` mid-tour.
    """
    return sorted(STAGE_REGISTRY)


class StageResolutionError(ValueError):
    """A stage reference could not be resolved in this worker.

    Distinct from a stage-body failure: the itinerary runner recognizes this
    (by name, through the RemoteError text) and degrades to fetching the
    state and running the stage driver-side instead of failing the tour.
    """


def resolve_stage(spec: str) -> Callable:
    """Resolve a stage reference: a registered name or ``pkg.mod:qualname``.

    Lambdas/closures are not addressable (their qualnames contain ``<``) —
    the itinerary runner localizes the state instead of sending those.
    Raises :class:`StageResolutionError` for anything this worker cannot
    import or look up.
    """
    fn = STAGE_REGISTRY.get(spec)
    if fn is not None:
        return fn
    mod_name, sep, qual = spec.partition(":")
    if not sep or not mod_name or not qual or "<" in qual:
        raise StageResolutionError(
            f"unresolvable stage reference {spec!r} (want 'pkg.mod:func' or a "
            "register_stage'd name)"
        )
    try:
        obj: Any = importlib.import_module(mod_name)
        for part in qual.split("."):
            obj = getattr(obj, part)
    except (ImportError, AttributeError) as e:
        raise StageResolutionError(f"cannot resolve stage {spec!r}: {e}") from e
    if not callable(obj):
        raise StageResolutionError(f"stage reference {spec!r} is not callable")
    return obj


def _n_leaves(state: Any) -> int:
    """Leaf count, as ``jax.tree_util.tree_leaves`` counts them (``None`` is
    an empty subtree)."""
    return len(flatten_with_paths(state)[0])


def _derive_step(state: Any, default: int = 0) -> int:
    """Display-step convention shared by svc/hop and svc/hop_stream: when the
    transport carries no step, read it from a conventional "step"/"t" leaf
    (a 0-d tensor is read wherever it lives)."""
    if default == 0 and isinstance(state, dict):
        for key in ("step", "t"):
            if key in state:
                try:
                    return int(state[key])
                except (TypeError, ValueError):
                    pass
                break
    return default


class NodeServer:
    def __init__(
        self,
        nbs: NBS,
        node_name: str,
        address,
        *,
        jobstore: JobStore | None = None,
    ):
        self.nbs = nbs
        self.node_name = node_name
        self.jobstore = jobstore
        self.resident: dict[str, tuple[Any, int]] = {}  # token -> (state, step)
        # token -> (path, bslice) -> hash, for states that arrived by stream;
        # lets a later svc/hop_stream delta against the resident baseline
        self.stream_grids: dict[str, dict[tuple, str]] = {}
        # cmi name -> receipt: makes svc/hop idempotent. The transit CMI is
        # GC'd after restore, so a client that lost its connection AFTER we
        # executed must get the original receipt back, not a missing-CMI error.
        self._hop_receipts: dict[str, dict] = {}
        # relay dest address -> (resident token on dest, sent chunk grid):
        # the delta baseline for the next svc/relay to that destination
        self._relay_baselines: dict[tuple, tuple[str, dict]] = {}
        self._listener, self.address = wire.listen(address)
        self._stop = threading.Event()
        self._accept_thread: threading.Thread | None = None
        self._last_accepted = None  # most recent accepted conn (test hook)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "NodeServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fabric-accept", daemon=True
        )
        self._accept_thread.start()
        logger.info("fabric node %s serving on %s", self.node_name, self.address)
        return self

    def stop(self) -> None:
        self._stop.set()
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
        """Block until svc/shutdown — or ``until()`` returns truthy (a
        serve-only worker passes its PreemptionNotice flag here, so a
        SIGTERM reclaim still terminates it)."""
        while not self._stop.wait(poll_s):
            if until is not None and until():
                return

    # -- transport ---------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            # accepted TCP sockets get the same policy as client sockets
            # (NODELAY + KEEPALIVE); accepted sockets do not reliably
            # inherit listener options
            wire.configure_stream_socket(conn)
            self._last_accepted = conn  # tests assert the accept-side options
            threading.Thread(
                target=self._serve_conn, args=(conn,), name="fabric-conn", daemon=True
            ).start()

    def _serve_conn(self, conn) -> None:
        with conn:
            reader = wire.FrameReader(conn)  # reusable recv_into buffer
            while not self._stop.is_set():
                try:
                    req = reader.recv_msg()
                except (OSError, wire.WireError):
                    return  # peer hung up (clean close or connection reset)
                if stream.is_stream_request(req):
                    # the connection switches to bulk mode for one session;
                    # on any error the session (and connection) dies without
                    # anything becoming resident
                    if not self._serve_hop_stream(conn, reader, req):
                        return
                    continue
                if stream.is_fetch_request(req):
                    # bulk mode in the OTHER direction: we pump, the peer acks
                    if not self._serve_fetch_stream(conn, reader, req):
                        return
                    continue
                try:
                    resp = self._dispatch(req)
                except faults.DropConnection as e:
                    # chaos: die at the injected protocol state without
                    # replying — the client sees a peer death mid-request
                    logger.warning("chaos: dropping connection at %s", e)
                    return
                try:
                    payload = wire.encode(resp)
                except Exception as e:
                    # a service returned something non-wire-serializable
                    # (e.g. an array from a passthrough handler): tell the
                    # caller which call failed instead of dropping the line
                    payload = wire.encode({
                        "id": resp.get("id"),
                        "ok": False,
                        "error": f"unserializable result: {type(e).__name__}: {e}",
                        "traceback": traceback.format_exc(),
                    })
                try:
                    conn.sendall(payload)
                except OSError:
                    return

    # -- dispatch ----------------------------------------------------------
    def _dispatch(self, req: Any) -> dict:
        rid = req.get("id") if isinstance(req, dict) else None
        try:
            if not isinstance(req, dict) or "svc" not in req:
                raise ValueError(f"malformed request: {req!r}")
            svc = req["svc"]
            kwargs = dict(req.get("kwargs") or {})
            result = self._invoke(svc, kwargs)
            return {"id": rid, "ok": True, "result": result}
        except faults.DropConnection:
            raise  # chaos kill_conn: handled by _serve_conn, never a reply
        except Exception as e:
            return {
                "id": rid,
                "ok": False,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc(),
            }

    def _invoke(self, svc: str, kwargs: dict) -> Any:
        if svc == "svc/ping":
            base = self.nbs.call(self.node_name, "svc/ping")
            return {**base, "pid": os.getpid(), "resident": len(self.resident),
                    "stages": registered_stages()}
        if svc == "svc/hop":
            return self._svc_hop(**kwargs)
        if svc == "svc/fetch":
            return self._svc_fetch(**kwargs)
        if svc == "svc/run_stage":
            return self._svc_run_stage(**kwargs)
        if svc == "svc/relay":
            return self._svc_relay(**kwargs)
        if svc == "svc/publish_resident":
            return self._svc_publish_resident(**kwargs)
        if svc == "svc/drop":
            self.stream_grids.pop(kwargs["token"], None)
            return {"dropped": self.resident.pop(kwargs["token"], None) is not None}
        if svc == "svc/shutdown":
            self._stop.set()
            return {"stopping": True}
        if svc in ("svc/list_jobs", "svc/get_job", "svc/publish_job", "svc/renew_lease"):
            return self._svc_jobstore(svc, kwargs)
        # anything else the node registered locally (handlers must speak
        # plain data for this to work — the service-shaped contract)
        return self.nbs.call(self.node_name, svc, **kwargs)

    # -- hop: the state lands HERE -----------------------------------------
    def _svc_hop(self, cmi: str, store_root: str | None = None, io_threads: int = 0,
                 gc: bool = True) -> dict:
        # Idempotency: we GC the transit CMI after restore, so a client whose
        # connection died AFTER we executed re-sends a request whose CMI no
        # longer exists. Dedup on the CMI name (transit names are uuid-fresh
        # per hop) and hand back the original receipt instead of failing.
        cached = self._hop_receipts.get(cmi)
        if cached is not None and cached["token"] in self.resident:
            logger.info("svc/hop: dedup retry of %s -> %s", cmi, cached["token"])
            return cached

        faults.fire("hop.before_restore")
        state = self.nbs.call(
            self.node_name, "svc/hop",
            cmi=cmi, store_root=store_root, io_threads=io_threads, gc=gc,
        )
        token = stream.fresh_token()
        # step travels in the CMI manifest; svc/hop returns only state, so
        # re-derive a display step from a conventional "step"/"t" leaf if any
        step = _derive_step(state)
        self.resident[token] = (state, step)
        receipt = {"token": token, "step": step, "leaves": _n_leaves(state),
                   "node": self.node_name}
        self._hop_receipts[cmi] = receipt
        faults.fire("hop.before_receipt")
        if len(self._hop_receipts) > 256:  # bound the dedup memory
            self._hop_receipts = {
                k: v for k, v in self._hop_receipts.items() if v["token"] in self.resident
            }
        return receipt

    # -- remote itineraries: run the stage WHERE THE STATE LIVES -------------
    def _svc_run_stage(self, token: str, fn: str, step: int | None = None) -> dict:
        """Run a stage function on a resident state (Fig. 8's read/compute/
        write, executed inside the worker). The result becomes resident under
        a FRESH token — the old token (and its now-stale stream grid) dies,
        so a later delta can never negotiate against mutated state. The
        stage runs on the state where it lies: on the node's device;
        ``stage_s`` is the host's time in the call (device work it queued
        may still be running) and ``thread_cpu_s`` the CPU time the call
        took on this thread: near ``stage_s`` when the host, not a wait, is
        what took the time (a fresh process's first CUDA launches)."""
        func = resolve_stage(fn)
        if token not in self.resident:
            raise KeyError(f"no resident state {token!r}")
        state, res_step = self.resident.pop(token)
        self.stream_grids.pop(token, None)
        t0 = time.perf_counter()
        c0 = time.thread_time()
        try:
            new_state = func(state)
        except Exception:
            # the stage failed before producing a result: keep the input
            # resident (best effort) so the caller can still fetch/fall back
            self.resident[token] = (state, res_step)
            raise
        new_step = res_step if step is None else int(step)
        new_token = stream.fresh_token()
        self.resident[new_token] = (new_state, new_step)
        logger.info("svc/run_stage: %s on %s -> %s", fn, token, new_token)
        return {
            "token": new_token,
            "step": new_step,
            "leaves": _n_leaves(new_state),
            "node": self.node_name,
            "fn": fn,
            "stage_s": time.perf_counter() - t0,
            "thread_cpu_s": time.thread_time() - c0,
        }

    def _svc_relay(
        self,
        token: str,
        dest,
        step: int | None = None,
        chunk_bytes: int = 16 << 20,
        fail_after_chunks: int | None = None,
        drop: bool = True,
    ) -> dict:
        """Worker-initiated hop: stream a resident state straight to the
        worker at ``dest`` (its svc/hop_stream), bypassing driver and disk.

        Repeat relays to the same destination delta against the grid kept
        from the last successful send. On success the state has moved, so the
        local copy is dropped (hop semantics); on ANY failure the baseline
        for that destination is invalidated, the state stays resident, and
        the error surfaces so the driver can fall back to the store path.
        """
        if token not in self.resident:
            raise KeyError(f"no resident state {token!r}")
        faults.fire("relay.before_stream")
        state, res_step = self.resident[token]
        dest_addr = tuple(dest)
        baseline_token, baseline_grid = self._relay_baselines.get(dest_addr, (None, None))
        try:
            receipt, sent_grid = stream.send_state_stream(
                dest_addr,
                state,
                src=self.node_name,
                step=res_step if step is None else int(step),
                chunk_bytes=int(chunk_bytes),
                baseline_token=baseline_token,
                baseline_grid=baseline_grid,
                fault_point="relay.mid_stream",
                **({"fail_after_chunks": int(fail_after_chunks)}
                   if fail_after_chunks is not None else {}),
            )
        except Exception:
            # the receiver's end state is unknowable: never delta against it
            self._relay_baselines.pop(dest_addr, None)
            raise
        faults.fire("relay.after_stream")
        self._relay_baselines[dest_addr] = (receipt["token"], sent_grid)
        if drop:
            self.resident.pop(token, None)
            self.stream_grids.pop(token, None)
        logger.info(
            "svc/relay: %s -> %s as %s (%d chunks)",
            token, dest_addr, receipt.get("token"), receipt.get("chunks", -1),
        )
        return receipt

    def _svc_publish_resident(
        self,
        token: str,
        store_root: str,
        name: str,
        step: int | None = None,
        extra: dict | None = None,
        meta: dict | None = None,
        chunk_bytes: int = 16 << 20,
        writers: int = 1,
        parent: str | None = None,
        cas: bool = False,
    ) -> dict:
        """Save a resident state as a committed CMI at ``store_root`` (the
        caller's jobstore cmi_root on the shared filesystem) WITHOUT dropping
        the resident copy — the disk-durable mid-tour publish. ``extra``
        bookkeeping keys ride only in the saved copy; non-dict states are
        wrapped exactly like Itinerary.run's local publish path so resume()
        can unwrap either.

        With ``cas=True`` the save is content-addressed (manifest v4) and
        delta-chains against ``parent`` (the previous stage's manifest in the
        same store): successive tour-stage publishes write only the objects
        the shared store does not already hold, and concurrent workers
        publishing near-identical states dedupe under the store's fcntl
        publish/sweep discipline."""
        from repro_torch.checkpoint.serializer import SaveOptions
        from repro_torch.core.cmi import save_cmi

        if token not in self.resident:
            raise KeyError(f"no resident state {token!r}")
        state, res_step = self.resident[token]
        step = res_step if step is None else int(step)
        if extra:
            if isinstance(state, dict):
                saved = {**state, **extra}
            else:
                saved = {"state": state, **extra, "itinerary_wrapped": True}
        else:
            saved = state
        save_cmi(
            Path(store_root), name, saved, step=step,
            meta={"node": self.node_name, "resident": token, **(meta or {})},
            options=SaveOptions(chunk_bytes=int(chunk_bytes),
                                writers=int(writers) or 1,
                                parent=parent, cas=bool(cas)),
        )
        logger.info("svc/publish_resident: %s -> %s/%s (step %d)",
                    token, store_root, name, step)
        return {"cmi": name, "step": step}

    # -- hop_stream: the state arrives on the socket, not the disk ----------
    def _serve_hop_stream(self, conn, reader: wire.FrameReader, req: Any) -> bool:
        """One streaming session. Returns True iff the connection stays usable."""
        rid = req.get("id")
        kwargs = dict(req.get("kwargs") or {})
        fail_after = kwargs.pop("fail_after_chunks", None)  # fault-injection hook

        def lookup(token: str):
            if token in self.resident and token in self.stream_grids:
                return self.resident[token][0], self.stream_grids[token]
            return None

        try:
            faults.fire("hop_stream.accept", sock=conn)
            wire.send_msg(conn, {
                "id": rid, "ok": True,
                "result": {
                    "accept": True,
                    "baseline_ok": lookup(kwargs.get("baseline")) is not None
                    if kwargs.get("baseline") else False,
                    # compression/dedup negotiation: what WE can decompress
                    # (per-frame "z" markers) and that dup frames resolve here
                    "codecs": list(wire.speakable_codecs()),
                    "dup_ok": True,
                },
            })
            state, step, grid, counters = stream.receive_state_stream(
                reader, kwargs, baseline_lookup=lookup, fail_after_chunks=fail_after,
                device=self.nbs.node(self.node_name).device,
            )
        except Exception as e:
            # a torn stream never becomes resident; best-effort error report,
            # then drop the connection (its framing state is ambiguous)
            logger.warning("hop_stream from %r failed: %s", kwargs.get("src"), e)
            try:
                wire.send_msg(conn, {
                    "id": rid, "ok": False,
                    "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc(),
                })
            except OSError:
                pass
            return False
        token = stream.fresh_token()
        # same convention as svc/hop: derive a display step from the state
        # when the sender did not pass one
        step = _derive_step(state, step)
        self.resident[token] = (state, step)
        self.stream_grids[token] = grid
        self.nbs.plugins.emit("on_restart", node=self.node_name, cmi=None, step=step)
        result = {
            "token": token,
            "step": step,
            "leaves": _n_leaves(state),
            "node": self.node_name,
            "chunks": counters["chunks"],
        }
        try:
            faults.fire("hop_stream.before_receipt", sock=conn)
            wire.send_msg(conn, {"id": rid, "ok": True, "result": result})
        except OSError:
            # sender died between eos and receipt: don't strand the state
            self.resident.pop(token, None)
            self.stream_grids.pop(token, None)
            return False
        logger.info(
            "svc/hop_stream: %d chunks from %s resident as %s (step %d)",
            counters["chunks"], kwargs.get("src"), token, step,
        )
        return True

    # -- fetch_stream: the state goes BACK down the socket -------------------
    def _serve_fetch_stream(self, conn, reader: wire.FrameReader, req: Any) -> bool:
        """One reverse-streaming session. Returns True iff the connection
        stays usable. The resident copy is dropped only after the client's
        ack — a torn fetch leaves it recoverable via store-mediated fetch."""
        rid = req.get("id")
        kwargs = dict(req.get("kwargs") or {})
        token = kwargs.get("token")
        entry = self.resident.get(token)
        if entry is None:
            # plain error reply; no bulk frames were sent, framing is clean
            try:
                wire.send_msg(conn, {
                    "id": rid, "ok": False,
                    "error": f"KeyError: no resident state {token!r}",
                    "traceback": "",
                })
            except OSError:
                return False
            return True
        state, step = entry
        try:
            from repro_torch.checkpoint.serializer import state_stream_meta

            faults.fire("fetch_stream.accept", sock=conn)
            wire.send_msg(conn, {
                "id": rid, "ok": True,
                "result": {"accept": True, "meta": state_stream_meta(state),
                           "step": step},
            })
            _, n_chunks, _, _ = stream.pump_state_chunks(
                conn, state, chunk_bytes=int(kwargs.get("chunk_bytes", 16 << 20)),
                fault_point="fetch_stream.mid_pump",
                codec=wire.negotiate_codec(wire.available_codecs(),
                                           kwargs.get("codecs")),
                dedup=bool(kwargs.get("dup_ok")),
            )
            ack = reader.recv_msg()
            if not (isinstance(ack, dict) and ack.get("ack")):
                raise wire.WireError(f"expected fetch ack, got {ack!r}")
            faults.fire("fetch_stream.before_drop", sock=conn)
        except Exception as e:
            # client never acked: keep the state resident; the connection's
            # framing state is ambiguous, so drop the connection
            logger.warning("fetch_stream of %s failed mid-send: %s", token, e)
            return False
        if kwargs.get("drop", True):
            self.resident.pop(token, None)
            self.stream_grids.pop(token, None)
        try:
            wire.send_msg(conn, {
                "id": rid, "ok": True,
                "result": {"dropped": bool(kwargs.get("drop", True)),
                           "chunks": n_chunks},
            })
        except OSError:
            return False
        logger.info("svc/fetch_stream: %s left as %d chunks (step %d)",
                    token, n_chunks, step)
        return True

    def _svc_fetch(self, token: str, name: str | None = None, drop: bool = True) -> dict:
        from repro_torch.checkpoint.serializer import SaveOptions
        from repro_torch.core.cmi import save_cmi

        if token not in self.resident:
            raise KeyError(f"no resident state {token!r}")
        state, step = self.resident[token]
        name = name or f"hop-{uuid.uuid4().hex[:12]}"
        save_cmi(
            self.nbs.hop_root, name, state, step=step,
            meta={"src": self.node_name, "resident": token},
            options=SaveOptions(writers=1),
        )
        if drop:
            self.resident.pop(token, None)
            self.stream_grids.pop(token, None)
        return {"cmi": name, "step": step}

    # -- jobstore services --------------------------------------------------
    def _svc_jobstore(self, svc: str, kwargs: dict) -> Any:
        if self.jobstore is None:
            raise RuntimeError(f"node {self.node_name} serves no jobstore")
        if svc == "svc/list_jobs":
            return self.jobstore.svc_list_jobs()
        if svc == "svc/get_job":
            job = self.jobstore.svc_get_job(**kwargs)
            return None if job is None else job.to_json()
        if svc == "svc/renew_lease":
            return self.jobstore.renew_lease(**kwargs).to_json()
        job = self.jobstore.svc_publish_job(**kwargs)
        return job.to_json()
