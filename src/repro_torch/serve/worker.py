"""Serving worker: a fabric node whose resident states are in-flight requests.

``python -m repro_torch.serve.worker --name s0 --socket /tmp/s0.sock --store S
--jobstore J --serve-only --engine toy [--device cuda|cpu]``

Port of the JAX package's ``repro/serve/worker.py``. :class:`ServeHost` is
the continuous-batching loop behind the ``svc/serve_*`` services. The
"batch" is a rolling *set*: a request joins at admit (prefill), every
``svc/serve_step`` advances each active request by exactly one decode
step, and a request leaves alone at EOS — there is no batch barrier.

Each request is a jobstore job; its engine state (KV cache + position, see
``repro_torch.serve.engine``) is the CMI. The host publishes it
content-addressed (CAS v4) right after prefill — from that moment the
prefill work is durable and a no-notice SIGKILL costs at most
``publish_every`` decode steps — and again on cadence and on SIGTERM
notice. The CMI format and the wire are the JAX package's, so a request
crosses between the two packages' hosts.

Live migration is two phases over the streamed-hop wire (pre-copy, the VM
live-migration shape):

    warm     stream the full request state to the destination; it stays
             resident there (NOT active) and both sides keep the chunk-hash
             grid. Decode continues HERE — the warm copy goes stale by
             exactly the rows decoded after it.
    handoff  delta-stream against the warm baseline, then tell the
             destination to adopt the fresh token into its active set and
             drop the warm copy. The destination resumes decode at ``pos``
             — zero re-prefill.

The delta is negotiated on chunk-hash grids, never on device change hints:
decode writes the caches in place, so there is no unchanged copy of the
old rows to hint against. A streamed-in state lands on the worker's
device; :meth:`ServeHost.adopt` brings its token arrays (and the toy
engine's cache) back to numpy and its model caches onto the engine's device.

Either phase failing is safe: a torn warm copy just means the handoff
streams full; a torn handoff leaves the request active here (baselines
invalidated) and the router falls back to publish + resume via the store.

Services (all plain wire data, registered on the NBS node so NodeServer's
dispatch fallthrough serves them):

    svc/serve_admit    prefill + first publish; returns the first token
    svc/serve_step     one decode step for every active request
    svc/serve_status   per-request positions + lifetime counters and seconds
    svc/serve_publish  force a CMI publish for one request
    svc/serve_warm     pre-copy phase 1 (full/refresh stream to dest)
    svc/serve_handoff  pre-copy phase 2 (delta stream + remote adopt)
    svc/serve_adopt    destination side: resident token -> active request
    svc/serve_resume   restore a request from its last published CMI
    svc/serve_drop     forget a request (after a confirmed handoff)
    svc/serve_drain    hand every active request to one destination

The worker process also registers ``svc/kernel_launches`` (as the fabric
worker does), so a caller can count the K3 launches its prefills made.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import torch

from repro_torch.chaos import faults
from repro_torch.core.dhp import DHP
from repro_torch.core.jobstore import STATUS_CKPT, STATUS_FINISHED
from repro_torch.fabric import stream
from repro_torch.fabric.proxy import FabricClient
from repro_torch.fabric import worker as fabric_worker
from repro_torch.fabric.worker import EXIT_FINISHED, EXIT_PREEMPTED, NodeProcess, run_node_process
from repro_torch.serve.engine import is_done, make_engine, transcript
from repro_torch.utils import logger, tree_map


def _host_array(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class ServeHost:
    """Continuous-batching state machine for one serving worker.

    Runs identically in-process (``launch/serve.py --workers 0``) and behind
    a :class:`~repro_torch.fabric.server.NodeServer` — the fabric pieces
    (``dhp``, ``server``) are optional and only gate publish / migration,
    never decode semantics.
    """

    def __init__(
        self,
        engine,
        *,
        node_name: str = "serve",
        dhp=None,
        server=None,
        publish_every: int = 0,
        chunk_bytes: int = 1 << 20,
    ):
        self.engine = engine
        self.node_name = node_name
        self.dhp = dhp
        self.server = server  # NodeServer: resident/stream_grids for adopt
        self.publish_every = int(publish_every)
        self.chunk_bytes = int(chunk_bytes)
        self.active: dict[str, dict] = {}  # req_id -> engine state
        self.jobs: dict[str, str] = {}  # req_id -> job_id
        self.counters = {
            "prefills": 0, "decode_steps": 0, "publishes": 0,
            "migrations_in": 0, "migrations_out": 0, "resumes": 0,
        }
        # seconds spent in prefills, decode steps (each up to its token's
        # read, so the device's work is inside) and CMI publishes
        self.seconds = {"prefill": 0.0, "decode": 0.0, "publish": 0.0}
        # (req_id, dest address) -> (resident token on dest, sent grid,
        # done at warm time): the delta baseline for that request's handoff.
        # Per-REQUEST, not per-destination — concurrent migrations of
        # different requests to one worker must not clobber each other
        # (the fabric's relay keeps per-dest baselines; serve cannot).
        self._warm: dict[tuple[str, tuple], tuple[str, dict, int]] = {}
        self._since_publish: dict[str, int] = {}
        self._lock = threading.RLock()

    # -- service registration ------------------------------------------------
    def register(self, node) -> None:
        """Expose the serve services on an NBS node (plain-data handlers, so
        NodeServer's dispatch fallthrough serves them over the wire)."""
        node.register("svc/serve_admit", self.admit)
        node.register("svc/serve_step", self.step)
        node.register("svc/serve_status", self.status)
        node.register("svc/serve_publish", self.publish)
        node.register("svc/serve_warm", self.warm)
        node.register("svc/serve_handoff", self.handoff)
        node.register("svc/serve_adopt", self.adopt)
        node.register("svc/serve_resume", self.resume)
        node.register("svc/serve_drop", self.drop)
        node.register("svc/serve_drain", self.drain)

    # -- admit / step / status -----------------------------------------------
    def admit(self, req_id: str, prompt: list, max_new: int,
              job_id: str | None = None) -> dict:
        with self._lock:
            faults.fire("serve.admit")
            if req_id in self.active:
                raise ValueError(f"request {req_id!r} already active")
            t0 = time.perf_counter()
            state = self.engine.prefill(np.asarray(prompt, np.int32), int(max_new))
            prefill_s = time.perf_counter() - t0
            self.counters["prefills"] += 1
            self.seconds["prefill"] += prefill_s
            self.active[req_id] = state
            if job_id is not None:
                self.jobs[req_id] = job_id
            self._since_publish[req_id] = 0
            # durable immediately: prefill is the "hours of work" — from here
            # on even a no-notice kill resumes with zero re-prefill
            self._publish_ckpt(req_id)
            return {
                "id": req_id,
                "tokens": [[0, int(state["out"][0])]],
                "pos": int(state["pos"]),
                "done": int(state["done"]),
                "prefill_s": prefill_s,
                "prompt_tokens": int(np.asarray(prompt).size),
            }

    def step(self) -> dict:
        """One decode step for EVERY active request (rolling batch: each
        request advances independently; finished ones leave alone)."""
        with self._lock:
            tokens: dict[str, list[list[int]]] = {}
            finished: list[str] = []
            for req_id in sorted(self.active):
                state = self.active[req_id]
                if is_done(state):
                    finished.append(req_id)
                    continue
                t0 = time.perf_counter()
                state = self.engine.decode(state)
                tokens[req_id] = [[int(state["done"]) - 1, int(state["tok"])]]
                self.seconds["decode"] += time.perf_counter() - t0
                self.active[req_id] = state
                self.counters["decode_steps"] += 1
                if is_done(state):
                    finished.append(req_id)
                else:
                    self._since_publish[req_id] = self._since_publish.get(req_id, 0) + 1
                    if self.publish_every > 0 and \
                            self._since_publish[req_id] >= self.publish_every:
                        self._publish_ckpt(req_id)
            for req_id in finished:
                self._finish(req_id)
            return {"tokens": tokens, "finished": finished, "active": len(self.active)}

    def status(self) -> dict:
        with self._lock:
            return {
                "node": self.node_name,
                "engine": self.engine.spec(),
                "counters": dict(self.counters),
                "seconds": dict(self.seconds),
                "requests": {
                    req_id: {"pos": int(st["pos"]), "done": int(st["done"]),
                             "eos": is_done(st)}
                    for req_id, st in self.active.items()
                },
            }

    def _finish(self, req_id: str) -> None:
        state = self.active.pop(req_id, None)
        self._since_publish.pop(req_id, None)
        job_id = self.jobs.pop(req_id, None)
        if state is None:
            return
        if self.dhp is not None and job_id is not None:
            self.dhp.publish(
                job_id, STATUS_FINISHED,
                product={"tokens": np.asarray(state["out"]), "req_id": req_id},
                step=int(state["done"]),
            )

    # -- publish / resume (the store leg) ------------------------------------
    def _publish_ckpt(self, req_id: str) -> str | None:
        if self.dhp is None:
            return None
        job_id = self.jobs.get(req_id)
        if job_id is None:
            return None
        state = self.active[req_id]
        t0 = time.perf_counter()
        name = self.dhp.publish(job_id, STATUS_CKPT, state, step=int(state["done"]))
        self.seconds["publish"] += time.perf_counter() - t0
        self.counters["publishes"] += 1
        self._since_publish[req_id] = 0
        return name

    def publish(self, req_id: str) -> dict:
        with self._lock:
            if req_id not in self.active:
                raise KeyError(f"no active request {req_id!r}")
            name = self._publish_ckpt(req_id)
            if name is None:
                raise RuntimeError("this host has no jobstore to publish into")
            return {"cmi": name, "step": int(self.active[req_id]["done"])}

    def publish_all(self) -> int:
        """SIGTERM-notice path: make every in-flight request durable."""
        with self._lock:
            n = 0
            for req_id in sorted(self.active):
                if self._publish_ckpt(req_id) is not None:
                    n += 1
            if self.dhp is not None:
                self.dhp.flush()
            return n

    def resume(self, req_id: str, job_id: str) -> dict:
        """Restore a request from its last published CMI and join the batch.

        Zero re-prefill by construction: the CMI holds the cache rows the
        original prefill (and every decode step up to the publish) wrote.
        The caches land on the engine's device; the token arrays and the toy
        engine's cache come back as numpy arrays, as the engines keep them.
        """
        with self._lock:
            if self.dhp is None:
                raise RuntimeError("this host has no jobstore to resume from")
            if req_id in self.active:
                raise ValueError(f"request {req_id!r} already active")
            state, _ = self.dhp.restart(job_id)
            state = self._landed(state)
            self.active[req_id] = state
            self.jobs[req_id] = job_id
            self._since_publish[req_id] = 0
            self.counters["resumes"] += 1
            return {
                "id": req_id,
                "pos": int(state["pos"]),
                "done": int(state["done"]),
                "tokens": [[i, t] for i, t in enumerate(transcript(state))],
            }

    def _landed(self, state: dict) -> dict:
        """A state restored from a CMI or streamed in, as the engine keeps it:
        the token arrays (and the toy engine's cache) as numpy arrays, the
        model caches on the engine's device."""
        state = {**state, "out": _host_array(state["out"]).astype(np.int32),
                 "prompt": _host_array(state["prompt"]).astype(np.int32),
                 "pos": int(state["pos"]), "done": int(state["done"]),
                 "tok": int(state["tok"])}
        if "kv" in state:
            state["kv"] = _host_array(state["kv"])
        if "caches" in state:
            dev = self.engine.device
            state["caches"] = tree_map(lambda t: t.to(dev), state["caches"])
        return state

    def drop(self, req_id: str) -> dict:
        with self._lock:
            gone = self.active.pop(req_id, None) is not None
            self.jobs.pop(req_id, None)
            self._since_publish.pop(req_id, None)
            return {"dropped": gone}

    # -- live migration (the stream leg) -------------------------------------
    def _stream_to(self, req_id: str, dest: tuple, baseline) -> tuple[dict, dict]:
        # no changed_hint: decode wrote the caches in place, so only the
        # baseline grid knows which chunks moved since the last send
        state = self.active[req_id]
        baseline_token, baseline_grid = (baseline[0], baseline[1]) if baseline else (None, None)
        return stream.send_state_stream(
            tuple(dest), state,
            src=self.node_name, step=int(state["done"]),
            chunk_bytes=self.chunk_bytes,
            baseline_token=baseline_token, baseline_grid=baseline_grid,
            fault_point="serve.migrate.mid_stream",
        )

    def warm(self, req_id: str, dest) -> dict:
        """Pre-copy phase 1: park a copy of the request on ``dest``.

        Decode continues here — the copy goes stale by exactly the rows
        decoded after this call, which is precisely what the handoff's
        delta stream will ship. A repeat warm to the same dest is itself a
        delta against the previous warm copy.
        """
        with self._lock:
            if req_id not in self.active:
                raise KeyError(f"no active request {req_id!r}")
            dest_addr = tuple(dest)
            key = (req_id, dest_addr)
            try:
                receipt, grid = self._stream_to(req_id, dest_addr, self._warm.get(key))
            except Exception:
                self._warm.pop(key, None)  # dest state unknowable: never delta
                raise
            stale = self._warm.get(key)
            self._warm[key] = (receipt["token"], grid, int(self.active[req_id]["done"]))
            if stale is not None:
                self._drop_remote(dest_addr, stale[0])
            return {"token": receipt["token"], "chunks": receipt["chunks"],
                    "data_chunks": receipt["data_chunks"],
                    "ref_chunks": receipt["ref_chunks"],
                    "sent_bytes": receipt["sent_bytes"],
                    "done": int(self.active[req_id]["done"])}

    def handoff(self, req_id: str, dest) -> dict:
        """Pre-copy phase 2: delta-stream against the warm copy, then the
        destination adopts the request and decode continues THERE.

        Works without a prior warm too — the stream is simply full. On any
        failure the request stays active here and the caller falls back to
        publish + resume.
        """
        with self._lock:
            if req_id not in self.active:
                raise KeyError(f"no active request {req_id!r}")
            dest_addr = tuple(dest)
            key = (req_id, dest_addr)
            warm = self._warm.get(key)
            try:
                receipt, _grid = self._stream_to(req_id, dest_addr, warm)
            except Exception:
                self._warm.pop(key, None)
                raise
            adopted = self._adopt_remote(
                dest_addr, req_id, receipt["token"], self.jobs.get(req_id),
                drop_token=warm[0] if warm else None,
            )
            self._warm.pop(key, None)
            self.active.pop(req_id, None)
            self.jobs.pop(req_id, None)
            self._since_publish.pop(req_id, None)
            self.counters["migrations_out"] += 1
            return {
                "id": req_id,
                "node": adopted.get("node"),
                "pos": adopted["pos"],
                "done": adopted["done"],
                "chunks": receipt["chunks"],
                "data_chunks": receipt["data_chunks"],
                "ref_chunks": receipt["ref_chunks"],
                "sent_bytes": receipt["sent_bytes"],
                "warm": warm is not None,
            }

    def adopt(self, req_id: str, token: str, job_id: str | None = None,
              drop_token: str | None = None) -> dict:
        """Destination side of a handoff: promote the streamed-in resident
        state to an active request. No prefill happens — ``pos`` carries on
        exactly where the source stopped."""
        with self._lock:
            if self.server is None:
                raise RuntimeError("adopt needs a NodeServer (resident states)")
            if req_id in self.active:
                raise ValueError(f"request {req_id!r} already active")
            entry = self.server.resident.pop(token, None)
            self.server.stream_grids.pop(token, None)
            if entry is None:
                raise KeyError(f"no resident state {token!r}")
            if drop_token is not None:  # retire the warm copy
                self.server.resident.pop(drop_token, None)
                self.server.stream_grids.pop(drop_token, None)
            state = self._landed(entry[0])
            self.active[req_id] = state
            if job_id is not None:
                self.jobs[req_id] = job_id
            self._since_publish[req_id] = 0
            self.counters["migrations_in"] += 1
            return {"id": req_id, "node": self.node_name,
                    "pos": int(state["pos"]), "done": int(state["done"])}

    def drain(self, dest) -> dict:
        """Hand every active request to ``dest`` (the upgrade path).

        All-or-nothing is NOT required: each request hands off
        independently, and any failure surfaces so the router can finish
        the drain per-request with its own fallbacks.
        """
        with self._lock:
            faults.fire("serve.drain")
            moved = []
            for req_id in sorted(self.active):
                self.handoff(req_id, dest)
                moved.append(req_id)
            return {"moved": moved}

    # -- remote control calls (short-lived client per call) ------------------
    def _adopt_remote(self, dest_addr: tuple, req_id: str, token: str,
                      job_id: str | None, drop_token: str | None) -> dict:
        with FabricClient(dest_addr) as client:
            return client.request(
                "svc/serve_adopt", req_id=req_id, token=token,
                job_id=job_id, drop_token=drop_token,
            )

    def _drop_remote(self, dest_addr: tuple, token: str) -> None:
        try:
            with FabricClient(dest_addr) as client:
                client.request("svc/drop", token=token)
        except Exception:  # best-effort: a stale warm copy is only memory
            logger.warning("could not retire stale warm copy %s on %s",
                           token, dest_addr)


# ---------------------------------------------------------------------------
# entrypoint
# ---------------------------------------------------------------------------


def build_parser():
    ap = fabric_worker.build_parser()
    ap.prog = "repro_torch.serve.worker"
    ap.add_argument("--engine", default="toy",
                    help="engine spec: toy[:d=..,vocab=..,seed=..] or "
                         "model:<arch>[:smoke|full][:seed=N]")
    ap.add_argument("--serve-chunk-bytes", type=int, default=1 << 20,
                    help="stream/publish chunk size for request state")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    host: ServeHost | None = None

    def setup(proc: NodeProcess) -> None:
        nonlocal host
        engine = make_engine(args.engine, device=proc.device)
        dhp = DHP(proc.nbs, args.name, proc.jobstore, chunk_bytes=args.serve_chunk_bytes) \
            if proc.jobstore is not None else None
        host = ServeHost(
            engine, node_name=args.name, dhp=dhp, server=proc.server,
            publish_every=args.publish_every, chunk_bytes=args.serve_chunk_bytes,
        )
        host.register(proc.node)

    def body(proc: NodeProcess) -> int:
        proc.server.serve_forever(until=proc.notice.imminent)
        if not proc.notice.imminent():
            return EXIT_FINISHED
        # the 2-minute notice: this is the migrate-or-publish moment. The
        # router may already have drained us; whatever is still active goes
        # durable so the resume leg loses at most the steps since the last
        # publish (a sigkill at this very point degrades to exactly that).
        # The publish copies the caches to the host (a synchronizing copy)
        # before the CMI commits.
        try:
            faults.fire("serve.reclaim.notice")
            n = host.publish_all()
            logger.warning("serve worker %s preempted; published %d in-flight "
                           "requests before exit", args.name, n)
        except Exception:
            logger.exception("notice-path publish failed; last cadence "
                             "publishes remain authoritative")
        return EXIT_PREEMPTED

    return run_node_process(args, body, setup=setup)


if __name__ == "__main__":
    sys.exit(main())
