"""The three elastic-fleet scenarios, as composable driver functions.

Port of the JAX package's ``repro/serve/scenarios.py``. Each takes a live
:class:`~repro_torch.fabric.supervisor.FabricSupervisor` and
:class:`~repro_torch.serve.router.ServeRouter` and performs one churn event
against the serving fleet; tests, the chaos matrix, and ``bench_serve``
compose them into full runs. They contain *policy only* — every mechanism
(pre-copy, delta handoff, store fallback, CAS resume) lives in the worker
and router layers.

    scale_out          load spike: spawn a fresh worker, shed half the
                       hottest worker's batch onto it (live migration)
    spot_reclaim       the spot market takes a worker. With notice, the
                       router drains what it can in the grace window and
                       the worker's SIGTERM path publishes the rest; without
                       notice (SIGKILL) the router resumes every stranded
                       request from its last CAS publish on a survivor
    drain_for_upgrade  planned maintenance: empty the worker, then retire
                       it politely
"""

from __future__ import annotations

from repro_torch.fabric.supervisor import FabricSupervisor
from repro_torch.serve.router import ServeRouter

SERVE_MODULE = "repro_torch.serve.worker"


def spawn_serve_worker(
    sup: FabricSupervisor,
    name: str,
    *,
    engine_spec: str,
    publish_every: int = 0,
    chunk_bytes: int = 1 << 20,
    socket_path: str | None = None,
    grace_s: float = 120.0,
    wait: bool = True,
    device: str | None = None,
):
    """Provision one serving worker through the supervisor, on ``device``
    (default: the supervisor's)."""
    return sup.spawn(
        name,
        module=SERVE_MODULE,
        serve_only=True,
        publish_every=publish_every,
        grace_s=grace_s,
        wait=wait,
        socket_path=socket_path,
        device=device,
        extra_args=["--engine", engine_spec,
                    "--serve-chunk-bytes", str(int(chunk_bytes))],
    )


def scale_out(
    sup: FabricSupervisor,
    router: ServeRouter,
    new_name: str,
    *,
    engine_spec: str,
    publish_every: int = 0,
    chunk_bytes: int = 1 << 20,
) -> list[str]:
    """Spawn ``new_name`` and live-migrate half the hottest worker's batch
    onto it. Returns the moved request ids."""
    handle = spawn_serve_worker(
        sup, new_name, engine_spec=engine_spec,
        publish_every=publish_every, chunk_bytes=chunk_bytes,
    )
    router.add_worker(new_name, handle.address)
    if not router.pending():
        return []
    hot = max(router.workers, key=lambda n: (router.load(n), n != new_name))
    k = router.load(hot) // 2
    return router.shed(hot, new_name, k) if k else []


def spot_reclaim(
    sup: FabricSupervisor,
    router: ServeRouter,
    victim: str,
    survivor: str,
    *,
    notice: bool,
    wait_s: float = 60.0,
) -> dict:
    """Reclaim ``victim``. ``notice=True`` drains into the grace window
    first (live migration; the worker's own SIGTERM publish-all covers
    whatever the drain missed), then SIGTERMs. ``notice=False`` SIGKILLs
    and resumes every stranded request from its last CAS publish."""
    moved: list[str] = []
    if notice:
        # migrate-or-publish: use the notice window to move requests live;
        # anything that fails the stream path falls back inside migrate()
        moved = router.drain(victim, survivor)
    rc = sup.reclaim(victim, notice=notice, wait_s=wait_s)
    resumed = router.recover(victim, survivor)
    return {"rc": rc, "moved": moved, "resumed": resumed}


def drain_for_upgrade(
    sup: FabricSupervisor,
    router: ServeRouter,
    victim: str,
    survivor: str,
    *,
    wait_s: float = 60.0,
) -> list[str]:
    """Planned maintenance: empty ``victim`` onto ``survivor`` (live, with
    per-request fallback), then retire the now-idle worker politely."""
    moved = router.drain(victim, survivor)
    router.remove_worker(victim)
    sup.reclaim(victim, notice=True, wait_s=wait_s)
    return moved
