"""ServeRouter: admit, step, and rebalance generation requests over workers.

Port of the JAX package's ``repro/serve/router.py``; it speaks the same
``svc/serve_*`` services, so it drives torch and JAX serving workers alike.

The router is the driver-side half of the serving subsystem: it owns the
request lifecycle and the authoritative transcripts, while the per-request
decode state lives (and moves) entirely between workers. One router thread
drives everything — admits interleave freely with step rounds (the rolling
batch has no barrier), and every per-request token arrives tagged with its
absolute index, so transcripts assemble identically no matter which worker
(or how many workers, or how many migrations) produced the tokens.

Policies the fleet scenarios compose from:

    migrate(req, dst)   live migration: warm (pre-copy) + delta handoff on
                        the streamed-hop wire; falls back to publish +
                        resume through the CAS store when the stream path
                        fails (``mode`` on the emitted event says which leg
                        actually carried the state)
    shed(src, dst, k)   scale-out: move k requests off a hot worker
    drain(src, dst)     upgrade: empty a worker (bulk svc/serve_drain,
                        per-request migration fallback)
    recover(dead, dst)  no-notice reclaim: every request assigned to the
                        dead worker resumes on ``dst`` from its last
                        published CMI — re-generated tokens overwrite
                        transcript slots with identical values (the engines
                        are deterministic), so recovery is idempotent

Events (``router.events``) record every admit/migrate/resume with enough
detail for the bench smoke contract: a "migrate" event's ``mode`` is
``"stream"`` only when the delta-hop wire actually carried the state.
"""

from __future__ import annotations

import time
from typing import Any

from repro_torch.fabric import wire
from repro_torch.fabric.proxy import FabricClient
from repro_torch.utils import logger


class WorkerLost(ConnectionError):
    """A worker stopped answering mid-call; carries the worker name."""

    def __init__(self, name: str, cause: Exception):
        super().__init__(f"worker {name} lost: {cause}")
        self.worker = name
        self.cause = cause


class ServeRouter:
    def __init__(self, jobstore=None):
        self.jobstore = jobstore
        self.workers: dict[str, dict] = {}  # name -> {"address", "client"}
        self.assignment: dict[str, str] = {}  # req_id -> worker name
        self.jobs: dict[str, str] = {}  # req_id -> job_id
        self.max_new: dict[str, int] = {}
        self.transcripts: dict[str, dict[int, int]] = {}  # req -> idx -> tok
        self.finished: set[str] = set()
        self.ttft_s: dict[str, float] = {}
        self.events: list[dict] = []
        self._admit_seq = 0

    # -- fleet membership ----------------------------------------------------
    def add_worker(self, name: str, address) -> None:
        self.workers[name] = {"address": tuple(address),
                              "client": FabricClient(tuple(address))}

    def remove_worker(self, name: str) -> None:
        entry = self.workers.pop(name, None)
        if entry is not None:
            entry["client"].close()

    def _client(self, name: str) -> FabricClient:
        return self.workers[name]["client"]

    def call(self, name: str, svc: str, **kwargs) -> Any:
        """One service call on a worker outside the request lifecycle: a
        read of its ``svc/serve_status`` or ``svc/kernel_launches``."""
        return self._client(name).request(svc, **kwargs)

    def _call(self, name: str, svc: str, **kwargs) -> Any:
        try:
            return self._client(name).request(svc, **kwargs)
        except (OSError, wire.WireError) as e:
            raise WorkerLost(name, e) from e

    def load(self, name: str) -> int:
        return sum(1 for r, w in self.assignment.items()
                   if w == name and r not in self.finished)

    # -- request lifecycle ---------------------------------------------------
    def admit(self, prompt, max_new: int, *, req_id: str | None = None,
              worker: str | None = None) -> str:
        """Prefill ``prompt`` on a worker and join the rolling batch.

        Picks the least-loaded worker unless one is named. A failed admit
        (worker error or death) retries on each remaining worker — the
        request is not active anywhere until exactly one admit succeeds.
        """
        if req_id is None:
            self._admit_seq += 1
            req_id = f"r{self._admit_seq:03d}"
        if req_id in self.assignment:
            raise ValueError(f"request {req_id!r} already admitted")
        prompt = [int(t) for t in prompt]
        job_id = None
        if self.jobstore is not None:
            job = self.jobstore.create_job(
                {"kind": "serve", "req_id": req_id, "prompt": prompt,
                 "max_new": int(max_new)})
            job_id = job.job_id
        candidates = ([worker] if worker is not None
                      else sorted(self.workers, key=lambda n: (self.load(n), n)))
        last: Exception | None = None
        for name in candidates:
            t0 = time.perf_counter()
            try:
                res = self._call(name, "svc/serve_admit", req_id=req_id,
                                 prompt=prompt, max_new=int(max_new),
                                 job_id=job_id)
            except (WorkerLost, wire.RemoteError) as e:
                logger.warning("admit of %s on %s failed (%s); trying next",
                               req_id, name, e)
                last = e
                continue
            self.ttft_s[req_id] = time.perf_counter() - t0
            self.assignment[req_id] = name
            if job_id is not None:
                self.jobs[req_id] = job_id
            self.max_new[req_id] = int(max_new)
            self.transcripts[req_id] = {}
            self._merge(req_id, res["tokens"])
            self.events.append({"kind": "admit", "req": req_id, "worker": name})
            return req_id
        raise RuntimeError(f"admit of {req_id!r} failed on every worker: {last!r}")

    def _merge(self, req_id: str, tokens: list) -> None:
        tr = self.transcripts[req_id]
        for idx, tok in tokens:
            prev = tr.get(int(idx))
            if prev is not None and prev != int(tok):
                raise AssertionError(
                    f"transcript divergence for {req_id} at {idx}: {prev} != {tok}"
                )
            tr[int(idx)] = int(tok)
        if len(tr) >= self.max_new[req_id]:
            self.finished.add(req_id)

    def step(self) -> int:
        """One decode round: every worker advances each of its requests by
        one step. Returns the number of tokens produced. Raises
        :class:`WorkerLost` if a worker died — the caller decides between
        :meth:`recover` and giving up."""
        produced = 0
        for name in sorted(self.workers):
            if self.load(name) == 0:
                continue
            res = self._call(name, "svc/serve_step")
            for req_id, toks in res["tokens"].items():
                if req_id in self.transcripts:
                    self._merge(req_id, toks)
                    produced += len(toks)
        return produced

    def pending(self) -> list[str]:
        return [r for r in self.assignment if r not in self.finished]

    def run_to_completion(self, *, max_rounds: int = 10_000) -> None:
        for _ in range(max_rounds):
            if not self.pending():
                return
            self.step()
        raise RuntimeError(f"requests still pending after {max_rounds} rounds: "
                           f"{self.pending()}")

    def transcript(self, req_id: str) -> list[int]:
        tr = self.transcripts[req_id]
        n = self.max_new[req_id]
        missing = [i for i in range(n) if i not in tr]
        if missing:
            raise AssertionError(f"transcript of {req_id} has holes at {missing}")
        return [tr[i] for i in range(n)]

    # -- rebalancing policies ------------------------------------------------
    def warm(self, req_id: str, dst: str) -> dict | None:
        """Best-effort pre-copy; a failure only means the handoff streams
        full instead of delta."""
        src = self.assignment[req_id]
        try:
            return self._call(src, "svc/serve_warm", req_id=req_id,
                              dest=list(self.workers[dst]["address"]))
        except (WorkerLost, wire.RemoteError) as e:
            logger.warning("warm of %s -> %s failed (%s); handoff will stream full",
                           req_id, dst, e)
            return None

    def handoff(self, req_id: str, dst: str) -> dict:
        src = self.assignment[req_id]
        res = self._call(src, "svc/serve_handoff", req_id=req_id,
                         dest=list(self.workers[dst]["address"]))
        self.assignment[req_id] = dst
        return res

    def migrate(self, req_id: str, dst: str, *, warm: bool = True) -> dict:
        """Move one in-flight request; live (stream) first, store fallback.

        The emitted event's ``mode`` records which leg carried the state:
        ``"stream"`` for a successful delta handoff, ``"store"`` when the
        stream path failed and the request traveled as publish + resume.
        """
        src = self.assignment[req_id]
        if src == dst:
            return {"id": req_id, "mode": "noop"}
        if req_id in self.finished:
            return {"id": req_id, "mode": "noop"}
        if warm:
            self.warm(req_id, dst)
        try:
            res = self.handoff(req_id, dst)
            event = {"kind": "migrate", "mode": "stream", "req": req_id,
                     "src": src, "dst": dst,
                     "chunks": res["chunks"], "data_chunks": res["data_chunks"],
                     "ref_chunks": res["ref_chunks"], "sent_bytes": res["sent_bytes"],
                     "warm": res["warm"]}
            self.events.append(event)
            return event
        except (WorkerLost, wire.RemoteError) as e:
            logger.warning("live migration of %s %s->%s failed (%s); "
                           "falling back to publish+resume", req_id, src, dst, e)
        # store fallback: durable publish on the source, restore on the
        # destination, then retire the source copy. Requires a jobstore.
        job_id = self.jobs.get(req_id)
        if job_id is None:
            raise RuntimeError(
                f"stream migration of {req_id!r} failed and no jobstore is "
                "configured for the store fallback")
        self._call(src, "svc/serve_publish", req_id=req_id)
        res = self._call(dst, "svc/serve_resume", req_id=req_id, job_id=job_id)
        self._merge(req_id, res["tokens"])
        self._call(src, "svc/serve_drop", req_id=req_id)
        self.assignment[req_id] = dst
        event = {"kind": "migrate", "mode": "store", "req": req_id,
                 "src": src, "dst": dst}
        self.events.append(event)
        return event

    def shed(self, src: str, dst: str, k: int) -> list[str]:
        """Scale-out: move the k most-recently-admitted active requests."""
        mine = [r for r in sorted(self.assignment)
                if self.assignment[r] == src and r not in self.finished]
        moved = []
        for req_id in mine[-k:]:
            self.migrate(req_id, dst)
            moved.append(req_id)
        return moved

    def drain(self, src: str, dst: str) -> list[str]:
        """Upgrade path: empty ``src`` onto ``dst``. Tries the worker-side
        bulk drain first; on failure finishes per-request (each with its own
        stream -> store fallback)."""
        try:
            res = self._call(src, "svc/serve_drain",
                             dest=list(self.workers[dst]["address"]))
            for req_id in res["moved"]:
                if self.assignment.get(req_id) == src:
                    self.assignment[req_id] = dst
            self.events.append({"kind": "drain", "mode": "bulk", "src": src,
                                "dst": dst, "moved": res["moved"]})
            return res["moved"]
        except (WorkerLost, wire.RemoteError) as e:
            logger.warning("bulk drain of %s failed (%s); migrating per-request",
                           src, e)
        moved = []
        for req_id in [r for r in sorted(self.assignment)
                       if self.assignment[r] == src and r not in self.finished]:
            self.migrate(req_id, dst)
            moved.append(req_id)
        self.events.append({"kind": "drain", "mode": "per-request", "src": src,
                            "dst": dst, "moved": moved})
        return moved

    def recover(self, dead: str, dst: str) -> list[str]:
        """Resume every request stranded on a dead worker from its last
        published CMI. The deterministic engines make this idempotent:
        re-generated tokens land on already-filled transcript slots with
        identical values."""
        self.remove_worker(dead)
        resumed = []
        for req_id in sorted(self.assignment):
            if self.assignment[req_id] != dead or req_id in self.finished:
                continue
            job_id = self.jobs.get(req_id)
            if job_id is None:
                raise RuntimeError(f"cannot recover {req_id!r}: no jobstore")
            res = self._call(dst, "svc/serve_resume", req_id=req_id, job_id=job_id)
            self._merge(req_id, res["tokens"])
            self.assignment[req_id] = dst
            resumed.append(req_id)
            self.events.append({"kind": "resume", "req": req_id, "from": dead,
                                "dst": dst, "done": res["done"]})
        return resumed

    # -- teardown ------------------------------------------------------------
    def close(self) -> None:
        for name in list(self.workers):
            self.remove_worker(name)
