"""Atomic CMI commit protocol (paper §Q4).

"DHP guarantees an atomic checkpointing phase … DHP makes sure to not replace
previous CMIs if the resources were reclaimed in the middle of an ongoing
checkpointing phase."

Protocol: all files (data, manifest, COMMIT marker — in that order, fsync'd)
are written into a staging directory ``<final>.stage-<pid>``; the staging dir
is then atomically ``os.replace``d into place. A reader therefore observes
either (a) no directory, (b) a fully consistent directory with COMMIT, or
(c) an orphaned staging directory, which readers ignore and GC removes. A
directory without COMMIT (e.g. partially copied by an external tool) is also
treated as absent.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

from repro_torch.chaos import faults

COMMIT_FILE = "COMMIT"
_STAGE_INFIX = ".stage-"


def is_committed(path: str | os.PathLike) -> bool:
    p = Path(path)
    return p.is_dir() and (p / COMMIT_FILE).is_file()


def list_committed(root: str | os.PathLike, prefix: str = "") -> list[Path]:
    root = Path(root)
    if not root.is_dir():
        return []
    out = [
        p
        for p in root.iterdir()
        if p.name.startswith(prefix) and _STAGE_INFIX not in p.name and is_committed(p)
    ]
    return sorted(out)


def _fsync_file(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: Path) -> None:
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:  # some filesystems refuse dir fsync; best-effort
        pass


class CommitScope:
    """Context manager staging a CMI directory and committing it atomically.

    Usage::

        with CommitScope(final_dir) as scope:
            # write files under scope.dir
            scope.write_text("manifest.json", manifest.dumps())
        # on clean exit: COMMIT written, fsync, atomic rename into final_dir
        # on exception: staging dir removed, final_dir untouched
    """

    def __init__(self, final_dir: str | os.PathLike, *, crash_after_data: bool = False):
        self.final = Path(final_dir)
        self.dir = Path(f"{self.final}{_STAGE_INFIX}{os.getpid()}-{int(time.time()*1e6)}")
        # fault-injection hook for tests: die after data is written but before
        # the commit rename, proving the previous CMI survives (paper Q4).
        self._crash_after_data = crash_after_data
        self._open_files: list[Path] = []
        self._synced: set[Path] = set()
        self._files_lock = threading.Lock()

    def __enter__(self) -> "CommitScope":
        self.dir.mkdir(parents=True, exist_ok=False)
        return self

    def path(self, name: str) -> Path:
        """Register (idempotently) a staged file for pre-commit fsync.

        Thread-safe: the parallel serializer registers every striped shard
        file (``data-0.bin … data-{W-1}.bin``) here, and COMMIT is only
        written after all of them are durably fsync'd.
        """
        p = self.dir / name
        with self._files_lock:
            if p not in self._open_files:
                self._open_files.append(p)
        return p

    def mark_synced(self, name: str) -> None:
        """Record that ``name`` was already fsync'd by its writer (e.g. the
        striped shard writers fsync concurrently on close), so the commit
        path skips the redundant serial re-fsync."""
        with self._files_lock:
            self._synced.add(self.dir / name)

    def write_text(self, name: str, text: str) -> Path:
        p = self.path(name)
        p.write_text(text)
        return p

    def write_json(self, name: str, obj) -> Path:
        return self.write_text(name, json.dumps(obj, sort_keys=True))

    def abort(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.abort()
            return False
        for f in self._open_files:
            if f not in self._synced and f.exists():
                _fsync_file(f)
        if self._crash_after_data:
            # Simulated preemption mid-commit: leave the torn staging dir on
            # disk exactly as a killed process would.
            raise _InjectedCrash(str(self.dir))
        # chaos point: data fsync'd, COMMIT not yet written — a sigkill here
        # is the paper's Q4 torn-commit; the stage dir must stay orphaned and
        # readers must never see this CMI
        faults.fire("publish.before_commit")
        commit = self.dir / COMMIT_FILE
        commit.write_text(json.dumps({"committed_at": time.time()}))
        _fsync_file(commit)
        _fsync_dir(self.dir)
        # Same-name overwrite: move old aside, rename new, drop old. The
        # window where both exist is crash-safe because readers key on
        # COMMIT inside whichever dir the final name points to. Retried:
        # a concurrent committer can re-create ``final`` between the
        # exists() check and the rename (ENOTEMPTY) — last commit wins.
        moved: list[Path] = []
        err: OSError | None = None
        for attempt in range(8):
            try:
                if self.final.exists():
                    old = Path(
                        f"{self.final}{_STAGE_INFIX}old-{os.getpid()}-{attempt}"
                    )
                    os.replace(self.final, old)
                    moved.append(old)
                os.replace(self.dir, self.final)
                err = None
                break
            except OSError as e:
                err = e
        if err is not None:
            # Terminal failure (ENOSPC/EIO/…): put the most recent previous
            # CMI back under the final name so it survives (Q4), then drop
            # our staged data and surface the error.
            if moved and moved[-1].exists() and not self.final.exists():
                try:
                    os.replace(moved[-1], self.final)
                    moved.pop()
                except OSError:  # pragma: no cover - best effort
                    pass
            self.abort()
            raise err
        for old in moved:
            shutil.rmtree(old, ignore_errors=True)
        _fsync_dir(self.final.parent)
        return False


class _InjectedCrash(RuntimeError):
    """Raised by the fault-injection hook; tests catch this."""


def gc_orphans(root: str | os.PathLike, *, min_age_s: float = 0.0) -> list[Path]:
    """Remove leftover staging directories (crashed commits). Returns removed."""
    root = Path(root)
    removed = []
    if not root.is_dir():
        return removed
    now = time.time()
    for p in root.iterdir():
        if _STAGE_INFIX in p.name and p.is_dir():
            if now - p.stat().st_mtime >= min_age_s:
                shutil.rmtree(p, ignore_errors=True)
                removed.append(p)
    return removed
