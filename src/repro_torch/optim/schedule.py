"""LR schedules (counterpart of the JAX package's ``optim/schedule.py``).

The schedule takes the step as a tensor and computes in float32, as the
``jnp`` version does against an int32 step.
"""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1):
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5 *
                      (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr
