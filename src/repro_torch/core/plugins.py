"""DMTCP-plugin-style event hooks (paper §2.4).

DMTCP plugins attach add-on behaviour around checkpoint events. The JAX
analogue is a small synchronous event bus with the same event taxonomy:

    on_checkpoint(node, cmi, step)   before a CMI is committed
    on_restart(node, cmi, step)      after a CMI is restored
    on_hop(src, dest, cmi, via)      around a migration
    on_publish(job_id, status, ...)  around a job-store publish
    on_preempt(node, grace_s)        when a reclaim notice lands

Used by tests (to observe ordering), by the metrics benchmark, and available
to applications (e.g. flushing open granule files before checkpoint — the
paper's "choose when it's safe to checkpoint" §Q2-2).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable

from repro_torch.utils import logger

EVENTS = ("on_checkpoint", "on_restart", "on_hop", "on_publish", "on_preempt")


class PluginBus:
    def __init__(self) -> None:
        self._subs: dict[str, list[Callable]] = defaultdict(list)
        self.log: list[tuple[str, dict]] = []  # bounded event trace

    def subscribe(self, event: str, fn: Callable) -> None:
        if event not in EVENTS:
            raise ValueError(f"unknown event {event!r}; valid: {EVENTS}")
        self._subs[event].append(fn)

    def emit(self, event: str, **kwargs: Any) -> None:
        self.log.append((event, kwargs))
        if len(self.log) > 10_000:
            del self.log[:5_000]
        for fn in self._subs.get(event, []):
            try:
                fn(**kwargs)
            except Exception:  # plugins must never take down the app
                logger.exception("plugin for %s raised", event)
