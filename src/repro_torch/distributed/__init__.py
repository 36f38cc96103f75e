"""Step builders (one device so far; meshes and FSDP are a later slice)."""

from repro_torch.distributed.steps import (  # noqa: F401
    make_init_fn,
    make_train_step,
    state_specs,
    train_state_from_numpy,
)
