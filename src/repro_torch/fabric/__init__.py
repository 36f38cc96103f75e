"""NavP process fabric — per-node worker processes behind real RPC.

The port of the JAX package's ``repro.fabric``, speaking its wire: a JAX
driver can call a torch worker and a torch worker can relay to a JAX one.

Modules:
  wire        Length-prefixed JSON/msgpack frames over unix/TCP sockets,
              plus the bulk-frame data plane for streaming transports.
  server      NodeServer: serves one node's services (svc/ping, svc/hop,
              svc/hop_stream, svc/fetch[_stream], svc/run_stage, svc/relay,
              svc/publish_resident, the three jobstore services) from
              inside a worker; streamed states land on the node's device.
  stream      The chunk pipeline shared by streamed hops, worker-to-worker
              relays, and streamed fetches (paper §Q5 on the wire).
  proxy       FabricClient + RemoteNode: ``nbs.call`` across the boundary.
  worker      ``python -m repro_torch.fabric.worker --device cuda|cpu`` —
              the process entrypoint, with the Figure-7 job loop and real
              SIGTERM notice handling.
  supervisor  FabricSupervisor: spawn/monitor/reclaim/replace workers;
              SpotSchedule-driven SIGTERM (2-min notice) and SIGKILL
              (no-notice) reclaims. Speaks ``unix`` or ``tcp`` transports
              and adopts agent-spawned workers it never forked.
  registry    Node registry: ``name -> (host, port)`` with heartbeat
              liveness (ALIVE -> SUSPECT -> DEAD) and re-resolution after
              respawn (``python -m repro_torch.fabric.registry``).
  agent       Per-host agent: spawns/respawns workers on wire request and
              reports exits to the registry
              (``python -m repro_torch.fabric.agent``).

The in-process :class:`~repro_torch.core.nbs.Node` stays the default
backend; this package is opt-in per node via ``NBS.add_remote_node`` or the
supervisor. Hops to (and between) process-backed nodes stream over the
fabric socket with transparent store-mediated fallback — itineraries tour
worker processes without the shared store in the happy path.
"""

from repro_torch.fabric.proxy import FabricClient, RemoteNode, RemoteStateRef, wait_ready  # noqa: F401
from repro_torch.fabric.server import NodeServer  # noqa: F401
from repro_torch.fabric.supervisor import AgentWorkerHandle, FabricSupervisor, WorkerHandle  # noqa: F401

# NOTE: repro_torch.fabric.worker, .registry, and .agent are deliberately NOT
# imported here — they are ``python -m`` entrypoints, and importing them from
# the package __init__ would trip runpy's double-import warning in every
# spawn (import them directly: ``from repro_torch.fabric.registry import ...``).
