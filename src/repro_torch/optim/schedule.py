"""Learning-rate schedules (the counterpart of ``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step: torch.Tensor, *, peak_lr: float, warmup: int,
                    total: int, floor: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor * peak_lr`` at ``total``. ``step`` is a device tensor;
    so is the result (no host read)."""
    s = step.float()
    warm = peak_lr * s / max(warmup, 1)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi
                                                               * frac)))
    return torch.where(s < warmup, warm, cos)
