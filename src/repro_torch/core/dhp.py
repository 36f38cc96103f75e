"""DHP — the "DMTCP Hop and Publish" tool (paper §2.4, §3, Figures 3 & 6).

Two utilities around checkpoint/restart:

``hop(state, dest)``   (Fig. 3)
    (1) checkpoint()                       -> save_cmi to the shared store
    (2) copy CMI + restart script to S3    -> (same step; store IS the S3)
    (3) request svc/hop on dest            -> nbs.call(dest, "svc/hop", ...)
    (4) exit                               -> source drops its reference

    ``via="live"`` implements the paper's §Q5 future work — the state goes
    straight to the destination device (``tensor.to(dest.device)``) without
    the intermediate disk write. ``via="auto"`` takes it for every
    in-process node; ``via="store"`` forces the disk-mediated path.
    ``via="stream"`` (across a process boundary) needs the fabric, which the
    port does not have yet.

``publish(job_id, status, ...)``  (Fig. 6)
    status == "ckpt":     checkpoint, upload CMI, svc/publish_job("ckpt")
    status == "finished": upload product,         svc/publish_job("finished")

    Async mode snapshots device→host synchronously, then serializes and
    publishes from a background thread so the step loop never waits on disk.
"""

from __future__ import annotations

import queue
import shutil
import threading
import uuid
from typing import Any

import torch

from repro_torch.chaos import faults
from repro_torch.checkpoint.serializer import SaveOptions
from repro_torch.core.cmi import restore_cmi, save_cmi, snapshot_to_host
from repro_torch.core.delta import DeltaPolicy, DeltaTracker
from repro_torch.core.jobstore import STATUS_CKPT, STATUS_FINISHED, JobStore
from repro_torch.core.nbs import NBS
from repro_torch.utils import logger, tree_map

_NEEDS_FABRIC = "needs the fabric, which repro_torch does not port yet"


class Preempted(RuntimeError):
    """Raised inside a worker when its instance is reclaimed mid-task."""


class DHP:
    def __init__(
        self,
        nbs: NBS,
        node: str,
        jobstore: JobStore | None = None,
        *,
        delta: DeltaPolicy | None = None,
        async_publish: bool = False,
        chunk_bytes: int = 16 << 20,
        writers: int = 0,
        io_threads: int = 0,
    ):
        self.nbs = nbs
        self.node = node
        self.jobstore = jobstore
        self.delta = DeltaTracker(delta or DeltaPolicy())
        self.async_publish = async_publish
        self.chunk_bytes = chunk_bytes
        # Parallel I/O engine knobs: striped save writers / concurrent restore
        # reads (0 = min(8, cpu_count) each; 1 = sequential).
        self.writers = writers
        self.io_threads = io_threads
        self._worker: threading.Thread | None = None
        self._q: queue.Queue = queue.Queue()
        self._pending = 0
        self._cv = threading.Condition()
        self._errors: list[Exception] = []

    # ------------------------------------------------------------------
    # hop (Fig. 3 + Fig. 4)
    # ------------------------------------------------------------------
    def hop(
        self,
        state: Any,
        dest: str,
        *,
        via: str = "auto",
        step: int = 0,
    ) -> Any:
        """Migrate ``state`` to node ``dest``; returns the state living there."""
        src = self.node
        dest_node = self.nbs.node(dest)  # raises if dest was reclaimed
        if via == "auto":
            via = "live"
        if via not in ("live", "store"):
            raise NotImplementedError(f"hop(via={via!r}) {_NEEDS_FABRIC}")
        self.nbs.plugins.emit("on_hop", src=src, dest=dest, via=via, cmi=None)
        if via == "live":
            # §Q5: the state goes straight onto the destination device
            out = _to_device_tree(state, dest_node.device)
            self.node = dest
            logger.info("hop(live) %s -> %s", src, dest)
            return out
        # store-mediated (Fig. 3): checkpoint -> S3 -> svc/hop(dest)
        name = f"hop-{uuid.uuid4().hex[:12]}"
        self.nbs.plugins.emit("on_checkpoint", node=src, cmi=name, step=step)
        save_cmi(
            self.nbs.hop_root,
            name,
            state,
            step=step,
            meta={"src": src, "dest": dest},
            options=SaveOptions(chunk_bytes=self.chunk_bytes, writers=self.writers),
        )
        del state  # (4) "exit": the source's copy is gone
        return self._restore_transit(src, dest, name)

    def _restore_transit(self, src: str, dest: str, name: str) -> Any:
        """Ask ``dest`` to restore transit CMI ``name`` (svc/hop).

        The destination GCs the CMI after a successful restore; on failure
        it is cleaned up here — either way the hop namespace never leaks.
        """
        try:
            # chaos point: the transit CMI is durably saved, the restore
            # request has not left yet — a failure here must still GC it
            faults.fire("hop.after_save")
            out = self.nbs.call(dest, "svc/hop", cmi=name, io_threads=self.io_threads)
        except Exception:
            shutil.rmtree(self.nbs.hop_root / name, ignore_errors=True)
            raise
        self.node = dest
        logger.info("hop(store) %s -> %s via %s", src, dest, name)
        return out

    def fetch(self, ref: Any, *, via: str = "auto") -> Any:
        raise NotImplementedError(f"fetch of a remote-resident state {_NEEDS_FABRIC}")

    def publish_ref(self, job_id: str, ref: Any, **kwargs) -> str:
        raise NotImplementedError(f"publish of a remote-resident state {_NEEDS_FABRIC}")

    # ------------------------------------------------------------------
    # publish (Fig. 6)
    # ------------------------------------------------------------------
    def publish(
        self,
        job_id: str,
        status: str,
        state: Any = None,
        *,
        step: int = 0,
        product: Any = None,
        meta: dict | None = None,
        changed_hint: dict | None = None,
    ) -> str | None:
        """Publish a checkpoint ("ckpt") or final product ("finished").

        Returns the CMI/product name. In async mode the device→host snapshot
        happens now; serialization + job-store update complete in background
        (``flush()`` joins them).
        """
        if self.jobstore is None:
            raise RuntimeError("publish requires a JobStore")
        if status == STATUS_CKPT:
            if state is None:
                raise ValueError('publish(status="ckpt") needs state')
            name = f"cmi-{step:010d}-{uuid.uuid4().hex[:8]}"
            parent = self.delta.parent_for(job_id, self.jobstore)
            # Durable publishes are content-addressed (manifest v4): chunks
            # land once in the job store's objects/ tree and successive
            # publishes write only the digests the store does not already
            # hold — the O(changed) publish that makes the paper's C cheap.
            opts = SaveOptions(
                chunk_bytes=self.chunk_bytes,
                parent=parent,
                changed_hint=changed_hint or {},
                writers=self.writers,
                cas=True,
            )
            self.nbs.plugins.emit("on_checkpoint", node=self.node, cmi=name, step=step)
            if self.async_publish:
                host_state = snapshot_to_host(state)
                self._submit(self._do_publish_ckpt, job_id, name, host_state, step, meta, opts)
            else:
                self._do_publish_ckpt(job_id, name, state, step, meta, opts)
            self.delta.record_published(job_id, name)
            return name
        if status == STATUS_FINISHED:
            self.flush()  # never finish before earlier ckpts land
            name = None
            if product is not None:
                name = f"product-{uuid.uuid4().hex[:8]}"
                save_cmi(
                    self.jobstore.cmi_root(job_id), name, product, step=step,
                    meta={"kind": "product", **(meta or {})},
                    options=SaveOptions(chunk_bytes=self.chunk_bytes,
                                        writers=self.writers, cas=True),
                )
            self.jobstore.svc_publish_job(job_id, STATUS_FINISHED, product=name, step=step)
            self.nbs.plugins.emit("on_publish", job_id=job_id, status=status, name=name)
            return name
        raise ValueError(f"unknown publish status {status!r}")

    def _do_publish_ckpt(self, job_id, name, state, step, meta, opts) -> None:
        faults.fire("publish.before_save")
        save_cmi(
            self.jobstore.cmi_root(job_id), name, state, step=step,
            meta={"node": self.node, **(meta or {})}, options=opts,
        )
        # chaos point: the CMI is committed but the job record does not name
        # it yet — a kill here must leave the PREVIOUS publish authoritative
        faults.fire("publish.before_record")
        self.jobstore.svc_publish_job(
            job_id, STATUS_CKPT, cmi=name, step=step,
            keep_last=self.delta.policy.keep_last,
        )
        self.nbs.plugins.emit("on_publish", job_id=job_id, status=STATUS_CKPT, name=name)

    # ------------------------------------------------------------------
    # restart (Fig. 7 line 5)
    # ------------------------------------------------------------------
    def restart(self, job_id: str, *, node: str | None = None) -> tuple[Any, int]:
        """Resume a "ckpt" job from its most recent published CMI, onto the
        node's device."""
        if self.jobstore is None:
            raise RuntimeError("restart requires a JobStore")
        node = node or self.node
        job = self.jobstore.read_job(job_id)
        if job.cmi is None:
            raise ValueError(f"job {job_id} has no published CMI")
        state, manifest = restore_cmi(
            self.jobstore.cmi_root(job_id), job.cmi, device=self.nbs.node(node).device,
            io_threads=self.io_threads,
        )
        self.nbs.plugins.emit("on_restart", node=node, cmi=job.cmi, step=manifest.step)
        self.delta.record_published(job_id, job.cmi)  # future deltas chain here
        return state, manifest.step

    # ------------------------------------------------------------------
    # async machinery
    # ------------------------------------------------------------------
    _SENTINEL = object()

    def _submit(self, fn, *args) -> None:
        # Count the task BEFORE enqueueing so flush() can never observe a
        # moment where the queue holds work but _pending reads 0.
        with self._cv:
            self._pending += 1
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._drain, name="dhp-publish", daemon=True
                )
                self._worker.start()
        self._q.put((fn, args))

    def _drain(self) -> None:
        # Persistent worker: blocks on the queue until close() posts the
        # sentinel.
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                return
            fn, args = item
            err: Exception | None = None
            try:
                fn(*args)
            except Exception as e:  # surfaced at flush()
                err = e
                logger.exception("async publish failed")
            finally:
                # error recording shares the cv lock with flush()'s drain so
                # a failure can never slip between the wait and the read
                with self._cv:
                    if err is not None:
                        self._errors.append(err)
                    self._pending -= 1
                    if self._pending == 0:
                        self._cv.notify_all()

    def flush(self, timeout: float = 300.0) -> None:
        """Join all in-flight async publishes; surface their failures.

        ALL queued errors are drained (under the cv lock): the first is
        raised, the rest ride along as ``__notes__`` — a later, unrelated
        ``flush()`` never inherits this batch's failures.
        """
        with self._cv:
            if not self._cv.wait_for(lambda: self._pending == 0, timeout=timeout):
                raise TimeoutError("async publish did not drain")
            errors, self._errors = self._errors, []
        if errors:
            first = errors[0]
            for other in errors[1:]:
                note = f"async publish also failed: {type(other).__name__}: {other}"
                if hasattr(first, "add_note"):  # 3.11+
                    first.add_note(note)
                else:  # 3.10: same __notes__ shape, minus traceback rendering
                    first.__notes__ = [*getattr(first, "__notes__", []), note]
            raise first

    def close(self, timeout: float = 300.0) -> None:
        """Drain pending publishes and retire the worker thread."""
        self.flush(timeout=timeout)
        with self._cv:
            worker, self._worker = self._worker, None
        if worker is not None:
            self._q.put(self._SENTINEL)
            worker.join(timeout=timeout)


def _to_device_tree(state: Any, device: torch.device) -> Any:
    """Every tensor leaf on ``device`` (live migration)."""
    return tree_map(lambda v: v.to(device) if isinstance(v, torch.Tensor) else v, state)
