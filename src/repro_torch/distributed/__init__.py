"""Sharding rules, DTensor placement and the step builders (init and train
on one device or a ``DeviceMesh``; prefill and decode on a mesh)."""

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
    cache_axes,
    make_decode_step,
    make_init_fn,
    make_prefill_step,
    make_train_step,
    model_axes_for,
    state_shardings,
    state_specs,
    state_struct_for,
    train_state_from_numpy,
)
