from repro_torch.optim.adamw import AdamWConfig, adamw_update, global_norm, init_opt_state  # noqa: F401
from repro_torch.optim.schedules import warmup_cosine  # noqa: F401
