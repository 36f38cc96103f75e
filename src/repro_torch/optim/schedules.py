"""LR schedules: pure functions of the step counter.

Port of the JAX package's ``repro/optim/schedules.py``. The schedule is
recomputable state, deliberately not stored in the CMI (the paper's
minimal-footprint principle). Computed in float32, as the reference's jnp
arithmetic is, on the CPU: the result is a 0-d float32 tensor.
"""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """``step``: an int or a 0-d tensor (any device). Linear warmup to
    ``peak_lr``, then a cosine down to ``floor * peak_lr`` at ``total``."""
    s = torch.as_tensor(step).detach().to("cpu", torch.float32)
    warm = peak_lr * torch.clamp(s / max(warmup, 1), max=1.0)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(frac * math.pi))
    return torch.where(s < warmup, warm, peak_lr * cos)
