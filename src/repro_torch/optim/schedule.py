"""LR schedules as functions of the step counter (the port of
``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine to
    ``min_ratio * peak_lr`` at ``total_steps``; an fp32 scalar tensor."""
    s = torch.as_tensor(step).float()
    warm = peak_lr * torch.clamp(s / max(warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup_steps, warm, cos)
