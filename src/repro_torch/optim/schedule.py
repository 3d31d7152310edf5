"""LR schedules (warmup + cosine) as pure functions of the step counter."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """The learning rate at ``step`` (an integer tensor), as a float32 tensor
    on its device: a linear warmup to ``peak_lr``, then a cosine down to
    ``floor * peak_lr`` at ``total``."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)
