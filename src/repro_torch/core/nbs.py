"""NBS — NavP Bridging Services (paper §3).

One NBS instance models a cluster: a set of *nodes* (Cloud instances), each
with its own torch device and a service registry, plus a shared store (the
S3 / shared-volume analogue). ``svc/hop`` on a node restores a CMI onto
*that node's* device and hands back the live state — Figure 4's

    (1) copy CMI and restart script from S3
    (2) run dmtcp_restart_script.sh

where step (2) is deterministic reconstruction: re-binding the state tree to
the destination device.

Everything is in-process but service-shaped: handlers take/return plain data
so fronting them with RPC is mechanical — ``add_remote_node`` does exactly
that for a node served by a worker process (``repro_torch.fabric``).
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import torch

from repro_torch.core.cmi import restore_cmi
from repro_torch.core.plugins import PluginBus
from repro_torch.utils import logger, resolve_device

HOP_NAMESPACE = "hops"


@dataclass(frozen=True)
class RemoteStateRef:
    """Receipt for state resident in another process after a remote hop.

    Lives in core (not ``repro_torch.fabric``) so state-consuming layers like
    itineraries can recognize "your state went somewhere you cannot touch
    it" without importing the fabric. ``via`` records which transport landed
    the state: ``"store"`` (disk-mediated Fig. 3/4) or ``"stream"`` (the
    §Q5 socket pipeline).

    Receipts are chainable: ``dhp.hop(ref, dest)`` relays the resident state
    worker-to-worker (``svc/relay``), ``dhp.fetch(ref)`` brings it back, and
    ``nbs.call(ref.node, "svc/run_stage", token=ref.token, fn=...)`` runs a
    stage function on it in place — which is how itineraries tour
    process-backed nodes without the state ever visiting the driver.
    """

    node: str
    token: str
    step: int
    leaves: int
    via: str = "store"


@dataclass
class Node:
    """A compute node: a named torch device + services (a Cloud instance).

    A process-backed node (``repro_torch.fabric.proxy.RemoteNode``) has no
    device in this process (``device`` is ``None``): its worker names its
    own in ``svc/ping``. A node on a ``DeviceMesh`` (``mesh``) holds its
    state as DTensors; ``device`` is then this rank's device of the mesh.
    """

    name: str
    device: torch.device | None
    services: dict[str, Callable] = field(default_factory=dict)
    meta: dict[str, Any] = field(default_factory=dict)
    mesh: Any = None

    # Process-backed subclasses that can receive a state stream over their
    # socket (``repro_torch.fabric.proxy.RemoteNode``) flip these; ``dhp.hop``
    # / ``dhp.fetch`` use them to prefer the §Q5 streaming transports over
    # store-mediation (hop_stream: state in; fetch_stream: state back out).
    supports_hop_stream = False
    supports_fetch_stream = False

    def register(self, svc_name: str, handler: Callable) -> None:
        self.services[svc_name] = handler

    def invoke(self, svc_name: str, /, **kwargs) -> Any:
        """Dispatch a service call on this node.

        Subclasses (``repro_torch.fabric.proxy.RemoteNode``) override this to
        carry the call across a process boundary; ``NBS.call`` goes through
        here so callers never care which backend a node runs on.
        """
        try:
            handler = self.services[svc_name]
        except KeyError:
            raise KeyError(f"node {self.name!r} has no service {svc_name!r}") from None
        return handler(**kwargs)


class NBS:
    """Service fabric: nodes + shared store + plugin event bus."""

    def __init__(self, store_root: str | os.PathLike):
        self.store_root = Path(store_root)
        (self.store_root / HOP_NAMESPACE).mkdir(parents=True, exist_ok=True)
        self.nodes: dict[str, Node] = {}
        self.plugins = PluginBus()

    # -- topology ----------------------------------------------------------
    def add_node(self, name: str, device: torch.device | str | None = None, *,
                 mesh: Any = None, **meta) -> Node:
        """Register an in-process node on ``device`` (default: the CUDA card;
        raises where there is none), or on ``mesh`` (a ``DeviceMesh``: state
        restored or hopped onto the node is placed on it)."""
        if name in self.nodes:
            raise ValueError(f"node {name!r} already registered")
        if mesh is not None:
            from repro_torch.distributed.sharding import mesh_device

            device = mesh_device(mesh)
        node = Node(name=name, device=resolve_device(device), meta=meta, mesh=mesh)
        self._install_default_services(node)
        self.nodes[name] = node
        return node

    def add_remote_node(self, name: str, address, *, resolver=None, **meta) -> Node:
        """Register a node served by another process (see ``repro_torch.fabric``).

        ``address`` is a fabric address tuple — ``("unix", path)`` or
        ``("tcp", host, port)``. Calls through ``nbs.call`` are carried over
        the socket; store-mediated hops work unchanged because the store is a
        shared filesystem. ``resolver`` (no-arg callable -> fresh address or
        None, e.g. :func:`repro_torch.fabric.registry.node_resolver`) lets the
        proxy re-resolve the node by name after a respawn moved it.
        """
        from repro_torch.fabric.proxy import RemoteNode  # lazy: core stays fabric-free

        if name in self.nodes:
            raise ValueError(f"node {name!r} already registered")
        node = RemoteNode.connect(name, address, meta=meta, resolver=resolver)
        self.nodes[name] = node
        return node

    def remove_node(self, name: str) -> None:
        """A spot reclaim: the node vanishes; in-flight work must re-hop."""
        node = self.nodes.pop(name, None)
        close = getattr(node, "close", None)
        if callable(close):
            close()
        logger.info("node %s reclaimed", name)

    def node(self, name: str) -> Node:
        try:
            return self.nodes[name]
        except KeyError:
            raise KeyError(f"no such node {name!r} (reclaimed?)") from None

    # -- service call ------------------------------------------------------
    def call(self, node_name: str, svc_name: str, /, **kwargs) -> Any:
        return self.node(node_name).invoke(svc_name, **kwargs)

    # -- default services ----------------------------------------------------
    def _install_default_services(self, node: Node) -> None:
        def svc_ping() -> dict:
            return {"node": node.name, "device": str(node.device),
                    "mesh": None if node.mesh is None else list(node.mesh.shape)}

        def svc_hop(
            cmi: str,
            store_root: str | None = None,
            io_threads: int = 0,
            gc: bool = True,
        ) -> Any:
            """Figure 4: restore the named CMI onto this node's device (its
            mesh, when it has one).

            Hop CMIs are transit baggage, not published products: once the
            state is live on this node the image is deleted (``gc=False`` to
            keep it), else long itineraries grow the store without bound.
            """
            root = Path(store_root) if store_root else self.store_root / HOP_NAMESPACE
            state, manifest = restore_cmi(root, cmi, device=node.device, mesh=node.mesh,
                                          io_threads=io_threads)
            self.plugins.emit("on_restart", node=node.name, cmi=cmi, step=manifest.step)
            if gc:
                shutil.rmtree(root / cmi, ignore_errors=True)
            logger.info("svc/hop: restored %s on node %s (step %d)", cmi, node.name, manifest.step)
            return state

        node.register("svc/ping", svc_ping)
        node.register("svc/hop", svc_hop)

    @property
    def hop_root(self) -> Path:
        return self.store_root / HOP_NAMESPACE
