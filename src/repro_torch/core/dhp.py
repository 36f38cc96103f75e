"""DHP — the "DMTCP Hop and Publish" tool (paper §2.4, §3, Figures 3 & 6).

Two utilities around checkpoint/restart:

``hop(state, dest)``   (Fig. 3)
    (1) checkpoint()                       -> save_cmi to the shared store
    (2) copy CMI + restart script to S3    -> (same step; store IS the S3)
    (3) request svc/hop on dest            -> nbs.call(dest, "svc/hop", ...)
    (4) exit                               -> source drops its reference

    ``via="live"`` implements the paper's §Q5 future work — the state goes
    straight to the destination device (``tensor.to(dest.device)``) without
    the intermediate disk write.

    ``via="stream"`` does the same across a *process* boundary: the CMI's
    chunks travel straight over the fabric socket
    (``repro_torch.fabric.stream``), never touching the disk — with a delta
    mode that resends only changed chunks when the destination still holds
    the previous hop's state. ``via="auto"`` takes "live" for in-process
    nodes and "stream" for stream-capable process-backed ones, and falls
    back transparently to the store-mediated path on any stream failure;
    ``via="store"`` forces the disk. ``publish`` never streams (durability
    needs the disk).

    ``hop`` also accepts a :class:`RemoteStateRef` receipt — the state then
    moves worker-to-worker (``svc/relay``, streamed, per-hop store
    fallback) without ever visiting this process; ``fetch(ref)`` brings a
    resident state home (streamed, store fallback) and ``publish_ref``
    checkpoints one disk-durably in place. Together these are what let
    itineraries tour process-backed nodes (``core/itinerary.py``).

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
from repro_torch.core.cmi import (mesh_resharding_resolver, restore_cmi, save_cmi,
                                  snapshot_to_host)
from repro_torch.core.delta import DeltaPolicy, DeltaTracker
from repro_torch.core.jobstore import STATUS_CKPT, STATUS_FINISHED, JobStore
from repro_torch.core.nbs import NBS, RemoteStateRef
from repro_torch.checkpoint.format import dtype_to_str
from repro_torch.utils import (flatten_with_paths, logger, resolve_device, tree_map,
                               unflatten_from_paths)


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
        self.home = node  # where fetched states land (see fetch)
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
        changed_hint: dict | None = None,
    ) -> Any:
        """Migrate ``state`` to node ``dest``; returns the state living there
        (a :class:`RemoteStateRef` receipt when ``dest`` is process-backed).

        ``changed_hint`` (per-array chunk bitmaps from
        ``core/delta.device_changed_hints``, K1 on the card) lets a streamed
        repeat hop skip copying and hashing chunks the device already proved
        unchanged.

        ``state`` may itself be a :class:`RemoteStateRef` receipt from an
        earlier hop: the resident state is then moved onward — worker to
        worker (``svc/relay``, streamed, with per-hop store fallback) or
        back into this process when ``dest`` is in-process.
        """
        if isinstance(state, RemoteStateRef):
            return self._hop_remote(state, dest, via=via, step=step)
        src = self.node
        dest_node = self.nbs.node(dest)  # raises if dest was reclaimed
        requested = via
        if via == "auto":
            if dest_node.device is not None:  # in-process: straight to its device
                via = "live"
            elif getattr(dest_node, "supports_hop_stream", False):
                via = "stream"
            else:
                via = "store"
        self.nbs.plugins.emit("on_hop", src=src, dest=dest, via=via, cmi=None)
        if via == "live":
            # §Q5: the state goes straight onto the destination device, or
            # is resharded onto the destination mesh
            if dest_node.device is None:
                raise ValueError(f"hop(via='live') needs an in-process node; {dest!r} "
                                 "is served by another process")
            if dest_node.mesh is not None:
                out = _reshard_tree(state, mesh_resharding_resolver(dest_node.mesh))
            else:
                out = _to_device_tree(state, dest_node.device)
            self.node = dest
            logger.info("hop(live) %s -> %s", src, dest)
            return out
        if via == "stream":
            # §Q5 across a process boundary: chunks go straight down the
            # socket. Any failure falls back to the store-mediated path, so
            # hop semantics (and preemption guarantees) are unchanged.
            if not getattr(dest_node, "supports_hop_stream", False):
                raise ValueError(f"hop(via='stream') needs a process-backed node; "
                                 f"{dest!r} is in this process")
            try:
                out = dest_node.hop_stream(
                    state, step=step, chunk_bytes=self.chunk_bytes,
                    changed_hint=changed_hint, src=src,
                )
                self.node = dest
                logger.info("hop(stream) %s -> %s", src, dest)
                return out
            except Exception as e:
                if requested == "stream":
                    # forced transport: surface the failure (matching
                    # fetch/receipt-hop semantics); only "auto" downgrades
                    raise
                logger.warning(
                    "hop(stream) %s -> %s failed (%s); falling back to store path",
                    src, dest, e,
                )
                self.nbs.plugins.emit("on_hop", src=src, dest=dest, via="store", cmi=None)
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

    # ------------------------------------------------------------------
    # receipt-aware hops: the state lives in another process
    # ------------------------------------------------------------------
    def _landing_device(self, device: torch.device | str | None = None) -> torch.device:
        """Where a state brought into this process lands: ``device``, else
        the device of the node this DHP was made on, else (that node being
        served by another process) the card, raising where there is none."""
        if device is not None:
            return torch.device(device)
        home = self.nbs.nodes.get(self.home)
        dev = getattr(home, "device", None)
        return resolve_device(None) if dev is None else dev

    def _hop_remote(self, ref: RemoteStateRef, dest: str, *, via: str = "auto",
                    step: int = 0) -> Any:
        """Move a remote-resident state onward — Fig. 8's chained tour.

        Happy path for a process-backed ``dest``: ``svc/relay`` on the
        holder, a worker-initiated ``svc/hop_stream`` straight to ``dest``
        (no driver, no disk in the data path). Any relay failure falls back
        *per hop* to the store path (``svc/fetch`` on the holder →
        ``svc/hop`` on ``dest``), so the durability guarantees are
        unchanged. An in-process ``dest`` pulls the state back here
        (streamed fetch, store fallback) onto its device.
        """
        src = ref.node
        if src == dest:
            self.node = dest
            return ref
        src_node = self.nbs.node(src)
        dest_node = self.nbs.node(dest)
        dest_client = getattr(dest_node, "client", None)
        if dest_client is None:
            # destination lives in THIS process: the tour comes home
            self.nbs.plugins.emit("on_hop", src=src, dest=dest, via="fetch", cmi=None)
            state = self.fetch(ref, via=via, device=dest_node.device)
            if dest_node.mesh is not None:
                state = _reshard_tree(state, mesh_resharding_resolver(dest_node.mesh))
            self.node = dest
            logger.info("hop(fetch) %s -> %s", src, dest)
            return state
        if via in ("auto", "stream") and getattr(dest_node, "supports_hop_stream", False):
            self.nbs.plugins.emit("on_hop", src=src, dest=dest, via="relay", cmi=None)
            try:
                # drop=False: the holder keeps its copy until the receipt is
                # safely HERE — if the receipt frame is lost after a relay
                # that actually succeeded, the fallback below still has a
                # live source to fetch from instead of a stranded dest copy
                kwargs = dict(token=ref.token, dest=list(dest_client.address),
                              step=step, chunk_bytes=self.chunk_bytes, drop=False)
                fail_after = getattr(dest_node, "_stream_fail_after", None)
                if fail_after is not None:  # fault injection (tests)
                    kwargs["fail_after_chunks"] = fail_after
                receipt = src_node.invoke("svc/relay", **kwargs)
            except Exception as e:
                if via == "stream":
                    raise
                logger.warning(
                    "hop(relay) %s -> %s failed (%s); per-hop store fallback",
                    src, dest, e,
                )
            else:
                try:
                    src_node.invoke("svc/drop", token=ref.token)  # confirmed
                except Exception as e:
                    logger.warning("post-relay drop of %s on %s failed: %s",
                                   ref.token, src, e)
                self.node = dest
                # the stream into dest: its delta accounting, as for hop_stream
                dest_node.last_stream_receipt = receipt
                logger.info("hop(relay) %s -> %s", src, dest)
                return RemoteStateRef(
                    node=receipt.get("node", dest),
                    token=receipt["token"],
                    step=int(receipt.get("step", step)),
                    leaves=int(receipt.get("leaves", 0)),
                    via="stream",
                )
        # per-hop store fallback (or via="store"): the holder re-publishes
        # the state as a transit CMI, dest restores it (Fig. 3 with the
        # holding worker as the source). The holder KEEPS its resident copy
        # until the destination restore is confirmed — if the restore fails
        # too (dest dead), the state survives on the holder and only the
        # transit CMI is cleaned up.
        self.nbs.plugins.emit("on_hop", src=src, dest=dest, via="store", cmi=None)
        name = f"hop-{uuid.uuid4().hex[:12]}"
        src_node.invoke("svc/fetch", token=ref.token, name=name, drop=False)
        out = self._restore_transit(src, dest, name)
        try:
            src_node.invoke("svc/drop", token=ref.token)  # (4) "exit", confirmed
        except Exception as e:
            logger.warning("post-hop drop of %s on %s failed: %s", ref.token, src, e)
        return out

    def fetch(self, ref: RemoteStateRef, *, via: str = "auto",
              device: torch.device | str | None = None) -> Any:
        """Bring a remote-resident state back into THIS process, onto
        ``device`` (default: the device of the node this DHP was made on;
        the card when that node is process-backed).

        ``via="auto"`` streams it over the fabric socket (bulk frames, no
        store write — paper §Q5 on the return leg) and falls back to the
        store-mediated ``svc/fetch`` + restore on any stream failure;
        ``"stream"``/``"store"`` force one path. The worker drops its
        resident copy once the state is safely here.
        """
        dev = self._landing_device(device)
        node = self.nbs.node(ref.node)
        if via in ("auto", "stream") and getattr(node, "supports_fetch_stream", False):
            try:
                state, _step = node.fetch_stream(ref.token, chunk_bytes=self.chunk_bytes,
                                                 device=dev)
                self.nbs.plugins.emit("on_hop", src=ref.node, dest=self.node,
                                      via="fetch_stream", cmi=None)
                logger.info("fetch(stream) %s from %s", ref.token, ref.node)
                return state
            except Exception as e:
                if via == "stream":
                    raise
                logger.warning("fetch(stream) of %s failed (%s); store fallback",
                               ref.token, e)
        # observable (plugins) so smoke harnesses can catch a silent
        # streamed-fetch regression falling back to the disk
        self.nbs.plugins.emit("on_hop", src=ref.node, dest=self.node,
                              via="fetch_store", cmi=None)
        fetched = node.invoke("svc/fetch", token=ref.token)
        state, _ = restore_cmi(self.nbs.hop_root, fetched["cmi"], device=dev,
                               io_threads=self.io_threads)
        # transit baggage, not a published product: GC once the state is live
        shutil.rmtree(self.nbs.hop_root / fetched["cmi"], ignore_errors=True)
        logger.info("fetch(store) %s from %s via %s", ref.token, ref.node, fetched["cmi"])
        return state

    def publish_ref(self, job_id: str, ref: RemoteStateRef, *, step: int = 0,
                    extra: dict | None = None, meta: dict | None = None) -> str:
        """Publish a checkpoint of a REMOTE-resident state, disk-durably.

        The holding worker saves the CMI straight into the job's cmi_root on
        the shared store (``svc/publish_resident`` — the resident copy is
        untouched), then the job record is updated here. Mid-tour publishes
        therefore keep exactly the durability of local ones; ``extra``
        carries bookkeeping keys (e.g. ``itinerary_stage``) into the saved
        copy only.
        """
        if self.jobstore is None:
            raise RuntimeError("publish requires a JobStore")
        name = f"cmi-{step:010d}-{uuid.uuid4().hex[:8]}"
        # Delta-chain mid-tour publishes too: the holding worker saves v4
        # against the previous stage's manifest, so a tour stage that only
        # touched part of the state writes only the changed objects.
        parent = self.delta.parent_for(job_id, self.jobstore)
        self.nbs.plugins.emit("on_checkpoint", node=ref.node, cmi=name, step=step)
        self.nbs.call(
            ref.node, "svc/publish_resident",
            token=ref.token, store_root=str(self.jobstore.cmi_root(job_id)),
            name=name, step=step, extra=extra or {}, meta=meta or {},
            chunk_bytes=self.chunk_bytes, writers=self.writers or 1,
            parent=parent, cas=True,
        )
        self.jobstore.svc_publish_job(
            job_id, STATUS_CKPT, cmi=name, step=step,
            keep_last=self.delta.policy.keep_last,
        )
        self.delta.record_published(job_id, name)
        self.nbs.plugins.emit("on_publish", job_id=job_id, status=STATUS_CKPT, name=name)
        return name

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
        node's device (for a process-backed node, where :meth:`fetch` would
        land it)."""
        if self.jobstore is None:
            raise RuntimeError("restart requires a JobStore")
        node = node or self.node
        job = self.jobstore.read_job(job_id)
        if job.cmi is None:
            raise ValueError(f"job {job_id} has no published CMI")
        # a process-backed node has no device here: the state lands as a
        # fetched one does; a node on a mesh gets DTensors placed on it
        home = self.nbs.node(node)
        state, manifest = restore_cmi(
            self.jobstore.cmi_root(job_id), job.cmi,
            device=home.device or self._landing_device(), mesh=home.mesh,
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


def _reshard_tree(state: Any, resolver) -> Any:
    """Every tensor leaf placed per the resolver (live migration onto a
    mesh): a DTensor is redistributed from its recorded spec's remap, a
    tensor every rank holds whole is split into each rank's block."""
    from repro_torch.distributed.sharding import redistribute, sharding_of

    def put(path: str, leaf: Any) -> Any:
        if not isinstance(leaf, torch.Tensor):
            return leaf
        cur = sharding_of(leaf)
        sh = resolver(path, tuple(leaf.shape), dtype_to_str(leaf.dtype),
                      None if cur is None else cur.record())
        return leaf if sh is None else redistribute(leaf, sh)

    flat, treedef = flatten_with_paths(state)
    return unflatten_from_paths(treedef, {k: put(k, v) for k, v in flat.items()})
