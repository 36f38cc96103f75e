"""Serving on PyTorch: continuous batching whose request states are CMIs.

Every in-flight generation request is a small navigational program: its KV
cache + position is the application-chosen checkpoint (the paper's CMI),
which makes requests *migratable* — between workers over the streamed
delta-hop wire mid-generation, and across worker deaths via CAS publishes —
with bit-identical transcripts as the invariant. The CMI format and the
wire are the JAX package's (``repro.serve``), so a request crosses between
the two.

    repro_torch.serve.engine     per-request decode state (toy + torch model engines)
    repro_torch.serve.worker     ServeHost: the svc/serve_* services + entrypoint
    repro_torch.serve.router     ServeRouter: admission, stepping, rebalancing
    repro_torch.serve.scenarios  scale-out / spot-reclaim / drain fleet policies
"""

# Exports resolve lazily (PEP 562) so `python -m repro_torch.serve.worker`
# does not import the worker module twice (once via the package, once via
# runpy).
_EXPORTS = {
    "ModelEngine": "repro_torch.serve.engine",
    "ToyEngine": "repro_torch.serve.engine",
    "is_done": "repro_torch.serve.engine",
    "make_engine": "repro_torch.serve.engine",
    "run_reference": "repro_torch.serve.engine",
    "transcript": "repro_torch.serve.engine",
    "ServeRouter": "repro_torch.serve.router",
    "WorkerLost": "repro_torch.serve.router",
    "ServeHost": "repro_torch.serve.worker",
    "SERVE_MODULE": "repro_torch.serve.scenarios",
    "spawn_serve_worker": "repro_torch.serve.scenarios",
    "scale_out": "repro_torch.serve.scenarios",
    "spot_reclaim": "repro_torch.serve.scenarios",
    "drain_for_upgrade": "repro_torch.serve.scenarios",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)
