"""LR schedules: pure functions of the step counter, in f32."""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def warmup_cosine(step, *, base_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = step / max(warmup_steps, 1)
    frac = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return base_lr * torch.where(step < warmup_steps, warm, cos)


def constant(step, *, base_lr: float) -> torch.Tensor:
    return torch.full((), base_lr, dtype=torch.float32)
