"""Sharding-constraint context.

Port of the JAX package's ``repro/distributed/ctx.py``. The model code
stays mesh-agnostic: it calls ``constrain(x, kind)`` where the reference
constrains (the residual stream), and a step builder installs a
constraint for each kind. Where the reference steers GSPMD with
``with_sharding_constraint``:

* a DTensor is redistributed to an installed
  :class:`~repro_torch.distributed.sharding.NamedSharding`;
* a plain local tensor (the tensor-parallel steps compute on those,
  ``distributed/tp.py``) goes through an installed callable: under
  ``seq_shard`` the train step installs :class:`~repro_torch.distributed.tp.SeqParallel`
  for ``resid``, which makes the residual stream each model rank's block
  of the sequence (the layers all-gather it along S before the attention
  and the FFN and reduce-scatter their outputs).

Anything else, or a kind with nothing installed, is returned unchanged.
The reference's other kind, ``moe_buf`` (its ``moe_buf_shard``: the MoE
dispatch buffer placed as the experts are), is not a constraint here but
carried by the step's plan (``Plan.moe_buf_shard``, read by
``models/moe.py``): the buffer lives inside a layer that the train step
recomputes in its backward, on the autograd engine's device thread, which
does not see this context; ``resid`` is applied between the layers, so
the context reaches it.

Kinds:
  resid    — (B, S, E) residual stream between layers
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
    """``x`` under the constraint installed for ``kind``: a DTensor
    redistributed to an installed ``NamedSharding``, a plain tensor passed
    through an installed callable; otherwise ``x`` itself."""
    c = _CONSTRAINTS.get()
    if not c or kind not in c:
        return x
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import NamedSharding, redistribute

    want = c[kind]
    if isinstance(x, DTensor):
        return redistribute(x, want) if isinstance(want, NamedSharding) else x
    return x if isinstance(want, NamedSharding) else want(x)
