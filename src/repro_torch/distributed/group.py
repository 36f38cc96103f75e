"""Process groups: one process per rank, each in a group of its own run.

There is no cluster manager here: :func:`run_ranks` starts ``n`` processes
(``spawn``), gives each the group's address (``tcp://localhost:<port>``,
a free port), its world size and its rank, runs ``fn(rank, *args)`` in
each, and returns every rank's result, rank order. ``gloo`` on the CPU,
``nccl`` on CUDA with one card a rank (more ranks than visible cards
raises; nothing falls back to the CPU). A run may last as long as its
ranks make progress: every result and every :func:`beat` (a training
rank beats once a step) restarts its ``timeout_s``. A rank that fails,
dies or goes ``timeout_s`` without progress ends all of them and raises
here, so a test or an incarnation never waits on a lost peer. The group's
own timeout, which bounds its rendezvous and each collective, is the
same ``timeout_s``. The group is destroyed when
``fn`` returns, so the next run (the next incarnation of a job, perhaps
smaller) starts a fresh one.

:func:`in_group` does the same in this process for a group of one (the
1×1 mesh on the card).
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import queue
import socket
import time
import traceback
from typing import Any, Callable


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def check_devices(device_type: str, world: int) -> None:
    """Raise unless ``world`` ranks can each have a device of this type."""
    if device_type == "cuda":
        import torch

        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > have:
            raise RuntimeError(f"{world} cuda ranks need {world} cards; {have} visible "
                               "(pass --device cpu for gloo ranks on the host)")
    elif device_type != "cpu":
        raise ValueError(f"no process-group backend for device type {device_type!r}")


@contextlib.contextmanager
def in_group(rank: int, world: int, port: int, device_type: str, timeout_s: float):
    """Join the default group as ``rank`` of ``world`` (CUDA: on card
    ``rank``), and leave it destroyed."""
    import torch
    import torch.distributed as dist

    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend_for(device_type), init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s),
        **({"device_id": torch.device("cuda", rank)} if device_type == "cuda" else {}))
    try:
        yield
    finally:
        dist.destroy_process_group()


_progress = None  # a rank process's channel to run_ranks (None elsewhere)


def beat() -> None:
    """Tell :func:`run_ranks` that this rank is making progress (nothing
    outside a rank process)."""
    if _progress is not None:
        _progress.put((None, "beat", None))


def _child(fn, rank, world, port, device_type, timeout_s, threads, args, results):
    global _progress
    _progress = results
    try:
        if threads:
            import torch

            torch.set_num_threads(threads)
        with in_group(rank, world, port, device_type, timeout_s):
            beat()  # joined
            out = fn(rank, *args)
        results.put((rank, "ok", out))
    except BaseException as e:  # noqa: BLE001 - reported to the parent
        results.put((rank, "error", (type(e).__name__, str(e), traceback.format_exc())))


class RankError(RuntimeError):
    """A rank raised: ``kind`` is its exception's class name."""

    def __init__(self, rank: int, kind: str, message: str, tb: str):
        super().__init__(f"rank {rank} raised {kind}: {message}\n{tb}")
        self.rank, self.kind, self.message = rank, kind, message


def run_ranks(fn: Callable, world: int, *, args: tuple = (), device_type: str = "cpu",
              timeout_s: float = 300.0, threads: int = 0) -> list[Any]:
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each in its own
    process of a fresh group. ``fn`` and ``args`` are pickled (``fn`` a
    module-level function). ``threads`` sets each CPU rank's intra-op
    threads (0: torch's default). Raises :class:`RankError` for the first
    rank that raised, ``TimeoutError`` once ``timeout_s`` passes with no
    rank's result and no :func:`beat`; every process is ended either
    way."""
    check_devices(device_type, world)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, r, world, port, device_type, timeout_s, threads, args,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict[int, Any] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks made no progress in {timeout_s} s "
                                   f"(done: {sorted(out)})")
            try:
                rank, status, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died (exit {procs[dead[0]].exitcode})")
                continue
            deadline = time.monotonic() + timeout_s
            if status == "beat":
                continue
            if status == "error":
                raise RankError(rank, *value)
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=5)
        results.close()
