"""LR schedules (pure functions of the step counter)."""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule"]


def cosine_schedule(step, *, warmup: int = 100, total: int = 10_000,
                    min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup → cosine decay to min_ratio. Returns an lr *scale*,
    a float32 scalar on ``step``'s device (an int, or a tensor such as
    the optimizer's step counter)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos
