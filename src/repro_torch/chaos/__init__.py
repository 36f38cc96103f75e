"""Protocol-state fault injection and the chaos matrix (the JAX package's, ported).

``repro_torch.chaos.faults`` is the injection layer the port's store and
NavP modules consult at named protocol states; ``repro_torch.chaos.sites``
is the registry of those states; ``repro_torch.chaos.matrix`` arms one
fault per protocol state against real torch worker processes and checks
that every run recovers (``python -m repro_torch.chaos.matrix --smoke``;
not imported here, as it is a ``python -m`` entry point).
"""

from repro_torch.chaos.faults import (  # noqa: F401
    DropConnection,
    FaultInjected,
    FaultPlan,
    arm,
    fire,
    set_role,
)
from repro_torch.chaos.sites import FAMILIES, SITES  # noqa: F401
