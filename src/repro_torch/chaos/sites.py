"""The registry of injectable protocol states — the chaos surface, as data.

A copy of the JAX package's registry (``repro/chaos/sites.py``), so that
the port's ``faults.fire`` sites and ``faults.arm`` validate against the
same point names. The port fires every point in the registry, and its chaos
matrix (``repro_torch.chaos.matrix``) holds a cell for each; the JAX
package's coverage checker, pointed at this package's tree, holds the
registry 1:1 against those fire sites, matrix cells and ``docs/fabric.md``.

``faults.arm`` validates dotted points against this registry; single-token
points (``"p"``) stay unvalidated so unit tests can use ad-hoc points.
"""

from __future__ import annotations

# point -> what fires there (one line; docs/fabric.md carries the recovery
# invariant for each). Keys are "<family>.<state>"; states may themselves be
# dotted ("cas.publish.pre_link" — family "cas", state "publish.pre_link").
SITES: dict[str, str] = {
    # -- hop (store-mediated) ----------------------------------------------
    "hop.after_save": "after the transit CMI commits, before the svc/hop request",
    "hop.before_restore": "in the worker, before restoring the transit CMI",
    "hop.before_receipt": "in the worker, after restore, before the reply",
    # -- hop_stream (streamed hop into a worker) ---------------------------
    "hop_stream.accept": "in the worker, on the stream-hop control request",
    "hop_stream.mid_stream": "per bulk frame sent, sender side",
    "hop_stream.before_receipt": "in the worker, after assembly, before the final reply",
    # -- relay (worker-initiated onward hop) -------------------------------
    "relay.before_stream": "in the holding worker, before a worker-to-worker relay",
    "relay.mid_stream": "per relayed bulk frame",
    "relay.after_stream": "after the relay stream, before the holder drops its copy",
    # -- fetch_stream (streamed return leg) --------------------------------
    "fetch_stream.accept": "in the worker, on the streamed-fetch control request",
    "fetch_stream.mid_pump": "per chunk pumped back to the client",
    "fetch_stream.before_ack": "client side, before acking full assembly",
    "fetch_stream.before_drop": "in the worker, after the ack, before dropping the resident",
    # -- wire / proxy (transport itself) -----------------------------------
    "wire.send_bulk": "on every outgoing bulk frame (garble flips a payload byte)",
    "wire.recv_frame": "on every frame read",
    "proxy.request": "in RemoteNode before each RPC",
    # -- publish (the paper's Q4 atomic checkpointing phase) ---------------
    "publish.before_save": "in the worker, before save_cmi of a cadence publish",
    "publish.before_commit": "after staging, before the atomic COMMIT rename",
    "publish.before_record": "after COMMIT, before the jobstore records the new step",
    # -- lease (claim / heartbeat) -----------------------------------------
    "lease.after_claim": "in the worker, right after winning the fcntl lease",
    "lease.before_renew": "in the worker, before each heartbeat",
    # -- registry (name -> address resolution + liveness) ------------------
    "registry.heartbeat_gap": "in the beating process, before each registry heartbeat",
    "registry.resolve": "client side, before each reg/resolve lookup",
    # -- agent (per-host spawn/respawn service) ----------------------------
    "agent.spawn": "in the agent, on a spawn request, before the fork",
    "agent.respawn": "in the agent's watch loop, before a failure respawn",
    # -- cas (content-addressed object store, manifest v4) -----------------
    "cas.publish.pre_link": "per new object: after tmp fsync, before the atomic link",
    "cas.publish.post_objects": "all objects durable, before the manifest commit",
    "cas.gc.mid_sweep": "in the mark-and-sweep GC, before each object unlink",
    # -- wire, continued: compressed bulk payloads -------------------------
    "wire.bulk.decompress": "receiver side, on each compressed bulk payload before decompression",
    # -- serve (elastic serving fleet: continuous batching + migration) ----
    "serve.admit": "in the serving worker, on svc/serve_admit before prefill",
    "serve.migrate.mid_stream": "per bulk frame of a live-migration stream (warm or handoff)",
    "serve.reclaim.notice": "in the serving worker, on SIGTERM notice before the final publish-all",
    "serve.drain": "in the serving worker, on svc/serve_drain before the handoffs",
}

FAMILIES: tuple[str, ...] = tuple(
    sorted({point.split(".", 1)[0] for point in SITES})
)


def is_known(point: str) -> bool:
    """True for registered points AND ad-hoc single-token test points."""
    return point in SITES or "." not in point


def family(point: str) -> str:
    return point.split(".", 1)[0]
