from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, adamw_update, global_norm, init_opt_state, opt_axes)
from repro_torch.optim.schedules import warmup_cosine  # noqa: F401
