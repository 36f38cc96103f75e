"""Job store: the paper's SDS job database and its three services.

Jobs carry exactly the paper's statuses (§3.3)::

    "new"      — has input datasets, never ran
    "ckpt"     — interrupted/staged; latest CMI is a *special product*
    "finished" — final product published

plus a lease field so multiple workers (Cloud instances) can pull jobs
concurrently without double-claiming — the paper brackets this as the
"running" status it omits for brevity; at 1000-node scale it is mandatory.

Service API (in-process callables with service-shaped signatures; production
would put these behind RPC — see DESIGN.md §2):

    svc_list_jobs()                      -> [[job_id, status], ...]   (Fig. 5)
    svc_get_job(job_id=None, lease_s=..) -> Job | None                 (§3.3-2)
    svc_publish_job(job_id, status, ...)                               (§3.3-3)
    renew_lease(job_id, worker, ...)     -> Job      (heartbeat; LeaseLost if
                                            another worker stole the lease)

Storage is a directory tree with atomic JSON writes (tmp + rename) and
``fcntl`` advisory locks, so the store itself survives preemption mid-update.
"""

from __future__ import annotations

import fcntl
import json
import os
import shutil
import time
import uuid
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any

from repro_torch.chaos import faults
from repro_torch.checkpoint.atomic import gc_orphans, is_committed, list_committed
from repro_torch.checkpoint.cas import ObjectStore, referenced_digests
from repro_torch.checkpoint.serializer import load_manifest
from repro_torch.utils import logger

STATUS_NEW = "new"
STATUS_CKPT = "ckpt"
STATUS_FINISHED = "finished"
VALID_STATUS = (STATUS_NEW, STATUS_CKPT, STATUS_FINISHED)


class LeaseLost(RuntimeError):
    """A lease renewal found the lease held by a different worker."""


@dataclass
class Job:
    job_id: str
    status: str = STATUS_NEW
    input: dict[str, Any] = field(default_factory=dict)  # arch/shape/steps/...
    cmi: str | None = None  # latest published CMI dir name (relative to job dir)
    step: int = 0
    product: str | None = None  # product dir/file name once finished
    lease_owner: str | None = None
    lease_expiry: float = 0.0
    history: list[dict] = field(default_factory=list)

    def to_json(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_json(d: dict) -> "Job":
        return Job(**d)

    def leased(self, now: float | None = None) -> bool:
        return self.lease_owner is not None and (now or time.time()) < self.lease_expiry


class _Locked:
    def __init__(self, path: Path):
        self.path = path

    def __enter__(self):
        self.fd = os.open(self.path, os.O_CREAT | os.O_RDWR)
        fcntl.flock(self.fd, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        fcntl.flock(self.fd, fcntl.LOCK_UN)
        os.close(self.fd)
        return False


def _atomic_write_json(path: Path, obj: Any) -> None:
    tmp = path.with_suffix(f".tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}")
    tmp.write_text(json.dumps(obj, sort_keys=True))
    os.replace(tmp, path)


class JobStore:
    """Filesystem-backed job database (the S3-bucket + scheduler analogue)."""

    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)
        (self.root / "jobs").mkdir(parents=True, exist_ok=True)

    # -- paths ------------------------------------------------------------
    def job_dir(self, job_id: str) -> Path:
        return self.root / "jobs" / str(job_id)

    def cmi_root(self, job_id: str) -> Path:
        return self.job_dir(job_id)

    def _job_file(self, job_id: str) -> Path:
        return self.job_dir(job_id) / "job.json"

    def _lock(self, job_id: str) -> _Locked:
        return _Locked(self.job_dir(job_id) / ".lock")

    # -- CRUD -------------------------------------------------------------
    def create_job(self, input: dict[str, Any], job_id: str | None = None) -> Job:
        job_id = str(job_id if job_id is not None else self._next_id())
        jd = self.job_dir(job_id)
        jd.mkdir(parents=True, exist_ok=True)
        job = Job(job_id=job_id, input=input)
        with self._lock(job_id):
            if self._job_file(job_id).exists():
                raise FileExistsError(f"job {job_id} exists")
            _atomic_write_json(self._job_file(job_id), job.to_json())
        return job

    def _next_id(self) -> int:
        with _Locked(self.root / ".ids.lock"):
            ids = [int(p.name) for p in (self.root / "jobs").iterdir() if p.name.isdigit()]
            return (max(ids) + 1) if ids else 1

    def read_job(self, job_id: str) -> Job:
        return Job.from_json(json.loads(self._job_file(job_id).read_text()))

    def _update(self, job: Job, event: str) -> None:
        job.history.append({"t": time.time(), "event": event, "step": job.step})
        _atomic_write_json(self._job_file(job.job_id), job.to_json())

    # -- the paper's three services ----------------------------------------
    def svc_list_jobs(self) -> list[list[str]]:
        """Figure 5: ``[["1","new"], ["2","ckpt"], ["3","finished"]]``."""
        out = []
        for p in sorted(
            (self.root / "jobs").iterdir(),
            key=lambda p: (not p.name.isdigit(), int(p.name) if p.name.isdigit() else 0, p.name),
        ):
            if (p / "job.json").exists():
                j = self.read_job(p.name)
                out.append([j.job_id, j.status])
        return out

    def svc_get_job(
        self,
        job_id: str | None = None,
        *,
        worker: str = "worker-0",
        lease_s: float = 3600.0,
        steal: bool = True,
    ) -> Job | None:
        """Return the requested job, or claim the next not-finished job.

        With ``steal=False`` a specific-job claim respects a live lease held
        by another worker (returns ``None``); an *expired* lease is always
        claimable — that is how a healthy worker takes over from one that
        stopped heartbeating (``renew_lease``) without any explicit release.
        ``steal=True`` (the default) keeps supervisor-respawn semantics: the
        supervisor only re-claims a job when it knows the old worker is dead.
        """
        if job_id is not None:
            with self._lock(job_id):
                job = self.read_job(job_id)
                if not steal and job.leased() and job.lease_owner != worker:
                    return None
                job.lease_owner, job.lease_expiry = worker, time.time() + lease_s
                self._update(job, f"leased:{worker}")
            # chaos point: the lease is durably recorded, the claimant has
            # not started working — a kill here must expire into a steal
            faults.fire("lease.after_claim")
            return job
        for jid, status in self.svc_list_jobs():
            if status == STATUS_FINISHED:
                continue
            with self._lock(jid):
                job = self.read_job(jid)  # re-read under lock
                if job.status == STATUS_FINISHED or job.leased():
                    continue
                job.lease_owner, job.lease_expiry = worker, time.time() + lease_s
                self._update(job, f"leased:{worker}")
                faults.fire("lease.after_claim")
                return job
        return None

    def renew_lease(self, job_id: str, worker: str, lease_s: float = 3600.0) -> Job:
        """Heartbeat: extend ``worker``'s lease on ``job_id``.

        Raises :class:`LeaseLost` if another worker holds (or stole) the
        lease — the caller must stop publishing for this job. Renewals do
        not append history (they would dominate it at heartbeat cadence).
        """
        # chaos point: a sigkill here is a worker dying BETWEEN heartbeats —
        # the lease must expire on its own and become stealable
        faults.fire("lease.before_renew")
        with self._lock(job_id):
            job = self.read_job(job_id)
            if job.lease_owner != worker:
                raise LeaseLost(
                    f"job {job_id} lease is held by {job.lease_owner!r}, not {worker!r}"
                )
            job.lease_expiry = time.time() + lease_s
            _atomic_write_json(self._job_file(job_id), job.to_json())
        return job

    def svc_publish_job(
        self,
        job_id: str,
        status: str,
        *,
        cmi: str | None = None,
        step: int | None = None,
        product: str | None = None,
        keep_last: int = 2,
    ) -> Job:
        """§3.3(3): publish a "ckpt" (CMI = special product) or "finished" job."""
        if status not in (STATUS_CKPT, STATUS_FINISHED):
            raise ValueError(f"publishable statuses are ckpt/finished, got {status!r}")
        with self._lock(job_id):
            job = self.read_job(job_id)
            if job.status == STATUS_FINISHED:
                raise ValueError(f"job {job_id} already finished")
            if status == STATUS_CKPT:
                if cmi is None or not is_committed(self.cmi_root(job_id) / cmi):
                    raise ValueError(f"publish(ckpt) requires a committed CMI, got {cmi!r}")
                job.cmi = cmi
                if step is not None:
                    job.step = step
                job.status = STATUS_CKPT
                self._update(job, f"publish:ckpt:{cmi}")
            else:
                job.product = product
                if step is not None:
                    job.step = step
                job.status = STATUS_FINISHED
                job.lease_owner = None
                self._update(job, f"publish:finished:{product}")
        if status == STATUS_CKPT:
            self.gc_cmis(job_id, keep_last=keep_last)
        return job

    def wait_for_status(
        self, job_id: str, status: str, *, timeout_s: float = 60.0, poll_s: float = 0.05
    ) -> Job:
        """Block until ``job_id`` reaches ``status`` (supervisors watching
        workers in other processes; the store is the only shared medium)."""
        deadline = time.monotonic() + timeout_s
        while True:
            job = self.read_job(job_id)
            if job.status == status:
                return job
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"job {job_id} still {job.status!r}, wanted {status!r} after {timeout_s}s"
                )
            time.sleep(poll_s)

    def release(self, job_id: str, *, to_status: str | None = None) -> Job:
        with self._lock(job_id):
            job = self.read_job(job_id)
            job.lease_owner, job.lease_expiry = None, 0.0
            if to_status is not None:
                job.status = to_status  # interrupted jobs with no CMI → "new" (§3.3)
            self._update(job, "released")
        return job

    def release_worker_leases(self, worker: str) -> list[str]:
        """Release every live lease held by ``worker`` — the registry's DEAD
        callback calls this so a confirmed-dead node's jobs become claimable
        *now* instead of after the remaining lease window. Leases are
        re-checked under the per-job lock (the worker may have finished, or
        another claimant may have stolen an expired lease already); only
        leases still owned by ``worker`` are touched. Returns released ids.
        """
        released: list[str] = []
        for job_id, status in self.svc_list_jobs():
            if status == STATUS_FINISHED:
                continue
            with self._lock(job_id):
                job = self.read_job(job_id)
                if job.lease_owner != worker:
                    continue
                job.lease_owner, job.lease_expiry = None, 0.0
                self._update(job, f"lease-released:dead:{worker}")
                released.append(job_id)
        return released

    # -- CMI lifecycle ------------------------------------------------------
    def list_cmis(self, job_id: str) -> list[str]:
        jd = self.job_dir(job_id)
        return sorted(
            p.name for p in jd.iterdir() if p.name.startswith("cmi-") and is_committed(p)
        )

    def gc_cmis(self, job_id: str, keep_last: int = 2) -> list[str]:
        """Drop old CMIs, retaining delta-chain ancestors of anything kept.

        The paper replaces the last CMI with the latest; with v1–v3 delta
        chains we must keep every ancestor a kept CMI's chunks reference —
        ``parent`` links in manifests make the closure computable without
        reading data. v4 (content-addressed) manifests need no ancestor
        dirs at all: their chunks live in the shared object tree, so after
        dropping manifest dirs the ``keep_last`` policy becomes a
        manifest-root mark-and-sweep over the refcounted objects
        (:meth:`_gc_objects`).
        """
        cmis = self.list_cmis(job_id)
        keep = set(cmis[-keep_last:]) if keep_last > 0 else set()
        job = self.read_job(job_id)
        if job.cmi:
            keep.add(job.cmi)
        # close over delta parents (v4 chunks live in objects/, not parents)
        frontier = list(keep)
        while frontier:
            name = frontier.pop()
            try:
                man = load_manifest(self.cmi_root(job_id), name)
            except FileNotFoundError:
                continue
            if man.version < 4 and man.parent and man.parent not in keep:
                keep.add(man.parent)
                frontier.append(man.parent)
        removed = []
        for name in cmis:
            if name not in keep:
                shutil.rmtree(self.job_dir(job_id) / name, ignore_errors=True)
                removed.append(name)
        gc_orphans(self.job_dir(job_id))
        swept = self._gc_objects(job_id)
        if removed or swept:
            logger.debug("gc job %s: removed %s, swept %d object(s)",
                         job_id, removed, len(swept))
        return removed

    def _gc_objects(self, job_id: str) -> list[str]:
        """Mark-and-sweep the job's content-addressed object tree.

        Mark: every digest referenced by any *committed* manifest still in
        the job dir (surviving CMIs and products are the GC roots). Sweep:
        unlink everything else. The exclusive fcntl guard mutually excludes
        in-flight publishers (which hold the shared guard across object
        writes + manifest commit), so the mark set can never miss a
        manifest that commits mid-sweep.
        """
        root = self.cmi_root(job_id)
        store = ObjectStore(root)
        if not store.dir.is_dir():
            return []
        with store.sweep_guard():
            marked: set[str] = set()
            for name in list_committed(root):
                try:
                    marked |= referenced_digests(load_manifest(root, name))
                except Exception:
                    return []  # unreadable root: abort, sweep nothing
            return store.sweep(marked)
