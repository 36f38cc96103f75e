"""Content-addressed object store: the blake2b digest IS the chunk identity.

Manifest v4 CMIs do not carry their own ``data-*.bin`` stripes. Every chunk
lives exactly once in a store-level object tree::

    <store_root>/objects/<digest[:2]>/<digest>

and a v4 manifest is just a list of digest references (``ChunkEntry`` with
``ref="objects/<digest[:2]>"``, ``file=<digest>``, ``offset=0``) — which
resolves through the *unchanged* restore path: ``_ChunkReader.file_path(
owner, file)`` already joins ``root/owner/file``, so a digest reference is
read exactly like a v1–v3 delta reference into a sibling CMI.

Durability protocol (paper §Q4, extended to shared objects):

1. each absent object is written to a ``.tmp-*`` file in its bucket,
   fsync'd, then atomically ``os.replace``'d to its digest name
   (``cas.publish.pre_link`` fires between fsync and link — a SIGKILL
   there leaves only an invisible tmp file, never a torn object);
2. bucket directories are fsync'd once all objects are linked, then
   ``cas.publish.post_objects`` fires — a SIGKILL there leaves fully
   durable but unreferenced objects (benign orphans, swept by GC);
3. only then does ``CommitScope`` stage + COMMIT the manifest, so a
   manifest is never visible while any object it references is missing.

Because objects are immutable and content-named, concurrent publishers
racing on the same digest are idempotent: both write distinct tmp files
with identical bytes and the second ``os.replace`` is a no-op overwrite.
Publisher/GC coordination uses the store's existing fcntl discipline: a
publisher holds a *shared* ``flock`` on ``objects/.lock`` across object
writes and the manifest commit, while the mark-and-sweep GC takes it
*exclusive* — a sweep can never delete objects a mid-commit publisher is
about to reference, and a SIGKILLed holder releases the lock with the
process.
"""

from __future__ import annotations

import fcntl
import os
import queue
import threading
from pathlib import Path

from repro_torch.chaos import faults

OBJECTS_DIR = "objects"
_LOCK_FILE = ".lock"
_TMP_PREFIX = ".tmp-"


def object_ref(digest: str) -> str:
    """The ``ChunkEntry.ref`` value for a digest (the owning 'CMI' dir)."""
    return f"{OBJECTS_DIR}/{digest[:2]}"


def object_rel(digest: str) -> str:
    """Store-root-relative path of a digest's object file."""
    return f"{OBJECTS_DIR}/{digest[:2]}/{digest}"


def is_object_ref(ref: str | None) -> bool:
    """True when a chunk's ``ref`` points into the object tree (v4 chunk)."""
    return ref is not None and ref.startswith(OBJECTS_DIR + "/")


def referenced_digests(manifest) -> set[str]:
    """All object digests a manifest's chunk table references (GC mark set)."""
    out: set[str] = set()
    for aentry in manifest.arrays.values():
        for c in aentry.chunks:
            if is_object_ref(c.ref):
                out.add(c.file)
    return out


class ObjectStore:
    """Digest-addressed chunk objects under ``<root>/objects/``."""

    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)
        self.dir = self.root / OBJECTS_DIR

    def path(self, digest: str) -> Path:
        return self.dir / digest[:2] / digest

    def has(self, digest: str) -> bool:
        return self.path(digest).exists()

    def put(self, digest: str, buf) -> int:
        """Durably write one object; returns bytes written (0 on dedup hit).

        tmp-write + fsync + atomic link (``os.replace``). Idempotent under
        concurrent publishers: content-named files make the race benign.
        The caller is responsible for :meth:`fsync_buckets` afterwards.
        """
        final = self.path(digest)
        if final.exists():
            return 0
        bucket = final.parent
        bucket.mkdir(parents=True, exist_ok=True)
        tmp = bucket / f"{_TMP_PREFIX}{digest[:16]}-{os.getpid()}-{threading.get_ident()}"
        n = buf.nbytes if isinstance(buf, memoryview) else len(buf)
        try:
            with open(tmp, "wb") as f:
                f.write(buf)
                f.flush()
                os.fsync(f.fileno())
            faults.fire("cas.publish.pre_link")
            os.replace(tmp, final)
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
        return n

    def fsync_buckets(self, digests) -> None:
        """fsync every bucket dir (and ``objects/`` itself) the digests touch,
        making the links themselves durable before the manifest commits."""
        if not self.dir.is_dir():
            return
        for bucket in sorted({d[:2] for d in digests}):
            p = self.dir / bucket
            if p.is_dir():
                _fsync_dir(p)
        _fsync_dir(self.dir)

    def digests(self) -> list[str]:
        """All linked object digests (tmp files excluded), sorted."""
        out = []
        if not self.dir.is_dir():
            return out
        for bucket in self.dir.iterdir():
            if not bucket.is_dir():
                continue
            for f in bucket.iterdir():
                if not f.name.startswith(_TMP_PREFIX):
                    out.append(f.name)
        return sorted(out)

    def tmp_files(self) -> list[Path]:
        """Leftover ``.tmp-*`` files from killed publishers (benign; GC'able)."""
        out = []
        if not self.dir.is_dir():
            return out
        for bucket in self.dir.iterdir():
            if bucket.is_dir():
                out.extend(f for f in bucket.iterdir()
                           if f.name.startswith(_TMP_PREFIX))
        return sorted(out)

    # -- fcntl discipline ---------------------------------------------------

    def _lock_fd(self) -> int:
        self.dir.mkdir(parents=True, exist_ok=True)
        return os.open(self.dir / _LOCK_FILE, os.O_CREAT | os.O_RDWR, 0o644)

    def publish_guard(self) -> "_StoreLock":
        """Shared lock: held by a publisher across object writes + commit."""
        return _StoreLock(self._lock_fd(), fcntl.LOCK_SH)

    def sweep_guard(self) -> "_StoreLock":
        """Exclusive lock: held by the GC across mark + sweep."""
        return _StoreLock(self._lock_fd(), fcntl.LOCK_EX)

    def sweep(self, keep: set[str]) -> list[str]:
        """Delete every linked object not in ``keep`` (plus stale tmp files).

        Caller must hold :meth:`sweep_guard`. ``cas.gc.mid_sweep`` fires
        before each unlink — a SIGKILL mid-sweep strands only *unreferenced*
        objects, which the next sweep (or ``fsck``) accounts for; referenced
        objects are never touched.
        """
        removed: list[str] = []
        for tmp in self.tmp_files():
            tmp.unlink(missing_ok=True)
        for digest in self.digests():
            if digest in keep:
                continue
            faults.fire("cas.gc.mid_sweep")
            self.path(digest).unlink(missing_ok=True)
            removed.append(digest)
        return removed


class _StoreLock:
    def __init__(self, fd: int, op: int):
        self.fd = fd
        self.op = op

    def __enter__(self) -> "_StoreLock":
        fcntl.flock(self.fd, self.op)
        return self

    def __exit__(self, *exc) -> None:
        try:
            fcntl.flock(self.fd, fcntl.LOCK_UN)
        finally:
            os.close(self.fd)


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class ObjectWriterPool:
    """Parallel object writer: the CAS analogue of ``_StripedWriterPool``.

    Worker threads drain a bounded queue of ``(digest, buf)`` items into
    :meth:`ObjectStore.put`. Within one save, a digest is submitted at most
    once (the serializer's ``have_digest`` oracle filters dups), but the
    pool still guards with its own seen-set so two identical chunks hashed
    in the same window cannot race. Errors surface at :meth:`close`, which
    also fsyncs every touched bucket directory — objects are fully durable
    when ``close`` returns.
    """

    def __init__(self, store: ObjectStore, threads: int):
        self.store = store
        self.error: Exception | None = None
        self.written_bytes = 0
        self.n_written = 0
        self._digests: set[str] = set()
        self._lock = threading.Lock()
        self.q: queue.Queue = queue.Queue(maxsize=64)
        n = max(1, min(threads, max(2, os.cpu_count() or 1)))
        self.threads = [
            threading.Thread(target=self._run, name=f"cas-writer-{i}", daemon=True)
            for i in range(n)
        ]
        for t in self.threads:
            t.start()

    def _run(self) -> None:
        while True:
            item = self.q.get()
            if item is None:
                break
            if self.error is not None:
                continue  # drain only; the save is already doomed
            digest, buf = item
            try:
                n = self.store.put(digest, buf)
                with self._lock:
                    self.written_bytes += n
                    self.n_written += 1 if n else 0
            except Exception as e:
                self.error = e

    def submit(self, digest: str, buf) -> None:
        if self.error is not None:
            raise self.error
        with self._lock:
            if digest in self._digests:
                return
            self._digests.add(digest)
        self.q.put((digest, buf))

    def close(self) -> tuple[int, int]:
        for _ in self.threads:
            self.q.put(None)
        for t in self.threads:
            t.join()
        if self.error is not None:
            raise self.error
        self.store.fsync_buckets(self._digests)
        return self.written_bytes, self.n_written
