"""Serving host: the continuous-batching loop whose states are in-flight requests.

Port of the in-process half of the JAX package's ``repro/serve/worker.py``.
:class:`ServeHost` keeps a rolling *set* of requests: a request joins at
admit (prefill), every :meth:`ServeHost.step` advances each active request
by exactly one decode step, and a request leaves alone at EOS — there is no
batch barrier.

Each request is a jobstore job; its engine state (KV cache + position, see
``repro_torch.serve.engine``) is the CMI. The host publishes it
content-addressed (CAS v4) right after prefill — from that moment the
prefill work is durable and a no-notice kill costs at most
``publish_every`` decode steps — and again on cadence. :meth:`resume`
restores a request from its last CMI onto the engine's device with zero
re-prefill; the CMI format is shared, so a request published by the JAX
package's host resumes here.

Live migration (``warm``/``handoff``/``adopt``/``drain``), the service
registration on a fabric node and the serving worker process are the
serving fleet's, which is not ported yet: they raise
``NotImplementedError`` (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from repro_torch.chaos import faults
from repro_torch.core.jobstore import STATUS_CKPT, STATUS_FINISHED
from repro_torch.serve.engine import is_done, transcript
from repro_torch.utils import tree_map

_NEEDS_FABRIC = ("needs the serving fleet over the fabric, which is not ported yet "
                 "(ROADMAP queue 1, item 10)")


def _host_array(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class ServeHost:
    """Continuous-batching state machine for one serving host, in process.

    ``dhp`` (the port's :class:`~repro_torch.core.dhp.DHP`) is optional and
    only gates publish/resume, never decode semantics.
    """

    def __init__(self, engine, *, node_name: str = "serve", dhp=None,
                 publish_every: int = 0):
        self.engine = engine
        self.node_name = node_name
        self.dhp = dhp
        self.publish_every = int(publish_every)
        self.active: dict[str, dict] = {}  # req_id -> engine state
        self.jobs: dict[str, str] = {}  # req_id -> job_id
        self.counters = {
            "prefills": 0, "decode_steps": 0, "publishes": 0, "resumes": 0,
        }
        self._since_publish: dict[str, int] = {}
        self._lock = threading.RLock()

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
                state = self.engine.decode(state)
                self.active[req_id] = state
                self.counters["decode_steps"] += 1
                tokens[req_id] = [[int(state["done"]) - 1, int(state["tok"])]]
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
        name = self.dhp.publish(job_id, STATUS_CKPT, state, step=int(state["done"]))
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
            state = {**state, "out": _host_array(state["out"]).astype(np.int32),
                     "prompt": _host_array(state["prompt"]).astype(np.int32),
                     "pos": int(state["pos"]), "done": int(state["done"]),
                     "tok": int(state["tok"])}
            if "kv" in state:
                state["kv"] = _host_array(state["kv"])
            if "caches" in state:
                dev = self.engine.device
                state["caches"] = tree_map(lambda t: t.to(dev), state["caches"])
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

    def drop(self, req_id: str) -> dict:
        with self._lock:
            gone = self.active.pop(req_id, None) is not None
            self.jobs.pop(req_id, None)
            self._since_publish.pop(req_id, None)
            return {"dropped": gone}

    # -- the fabric half -------------------------------------------------------
    def register(self, node) -> None:
        raise NotImplementedError(f"serving services on a fabric node {_NEEDS_FABRIC}")

    def warm(self, req_id: str, dest) -> dict:
        raise NotImplementedError(f"live migration (warm) {_NEEDS_FABRIC}")

    def handoff(self, req_id: str, dest) -> dict:
        raise NotImplementedError(f"live migration (handoff) {_NEEDS_FABRIC}")

    def adopt(self, req_id: str, token: str, job_id: str | None = None,
              drop_token: str | None = None) -> dict:
        raise NotImplementedError(f"adopting a streamed-in request {_NEEDS_FABRIC}")

    def drain(self, dest) -> dict:
        raise NotImplementedError(f"draining to another worker {_NEEDS_FABRIC}")


def main(argv: list[str] | None = None) -> int:
    """The serving worker process (``python -m repro.serve.worker`` in the
    JAX package)."""
    raise NotImplementedError(f"the serving worker process {_NEEDS_FABRIC}")


if __name__ == "__main__":
    main()
