"""Serving on PyTorch: continuous batching whose request states are CMIs.

Every in-flight generation request is a small navigational program: its KV
cache + position is the application-chosen checkpoint (the paper's CMI),
published content-addressed and resumed with zero re-prefill, with
bit-identical transcripts as the invariant. The CMI format is the JAX
package's (``repro.serve``), so a request crosses between the two.

    repro_torch.serve.engine   per-request decode state (toy + torch model engines)
    repro_torch.serve.worker   ServeHost: the in-process rolling batch

The router, the fleet scenarios and live migration over the fabric
(``repro_torch.fabric``) are not ported yet (ROADMAP queue 1, item 10).
"""

from repro_torch.serve.engine import (  # noqa: F401
    ModelEngine,
    ToyEngine,
    is_done,
    make_engine,
    run_reference,
    transcript,
)
from repro_torch.serve.worker import ServeHost  # noqa: F401
