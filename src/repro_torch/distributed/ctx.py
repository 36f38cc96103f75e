"""Sharding-constraint context.

Port of the JAX package's ``repro/distributed/ctx.py``. The model code
stays mesh-agnostic: it calls ``constrain(x, kind)`` at a few points
(residual stream, MoE dispatch buffer), and a step builder installs a
:class:`~repro_torch.distributed.sharding.NamedSharding` for each kind.
Where the reference steers GSPMD with ``with_sharding_constraint``, here a
DTensor is redistributed to the installed placements. A plain tensor is
returned unchanged: the sharded train step (``distributed/steps.py``)
gathers each weight and computes on local tensors, so its activations are
plain tensors and these points are where tensor-parallel compute would
place them.

Kinds:
  resid    — (B, S, E) residual stream between layers
  moe_buf  — (X, C, E) expert dispatch buffer
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Mapping

_CONSTRAINTS: contextvars.ContextVar[Mapping[str, Any] | None] = contextvars.ContextVar(
    "sharding_constraints", default=None
)


@contextlib.contextmanager
def sharding_context(constraints: Mapping[str, Any]):
    token = _CONSTRAINTS.set(dict(constraints))
    try:
        yield
    finally:
        _CONSTRAINTS.reset(token)


def constrain(x, kind: str):
    """``x`` redistributed to the placements installed for ``kind`` when
    ``x`` is a DTensor and one is installed; otherwise ``x`` itself."""
    c = _CONSTRAINTS.get()
    if not c or kind not in c:
        return x
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import redistribute

    return redistribute(x, c[kind]) if isinstance(x, DTensor) else x
