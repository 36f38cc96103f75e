"""Sharding rules, DTensor placement and the step builders (one device or
a ``DeviceMesh``)."""

from repro_torch.distributed.sharding import (  # noqa: F401
    CACHE_RULES,
    DEFAULT_RULES,
    OPT_RULES,
    AbstractMesh,
    NamedSharding,
    P,
    PartitionSpec,
    batch_axes,
    data_pspec,
    placements_for,
    sharding_for,
    spec_for,
    tree_shardings,
)
from repro_torch.distributed.steps import (  # noqa: F401
    batch_shardings,
    make_init_fn,
    make_train_step,
    state_shardings,
    state_specs,
    train_state_from_numpy,
)
