from repro_torch.kernels.linear_recurrence.ops import (  # noqa: F401
    LinearRecurrence,
    linear_recurrence,
)
