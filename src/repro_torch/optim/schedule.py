"""LR schedules."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to `peak_lr` over `warmup` steps, then a cosine decay
    to `floor * peak_lr` at `total`; a float32 scalar, computed in float32
    as the reference's."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
