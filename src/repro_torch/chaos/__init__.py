"""Protocol-state fault injection (a copy of the JAX package's).

``repro_torch.chaos.faults`` is the injection layer the port's store and
NavP modules consult at named protocol states; ``repro_torch.chaos.sites``
is the registry of those states.
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
