"""Learning-rate schedules. Port of `repro.optim.schedules`: each maps a
step (an int or a tensor) to a float32 0-dim tensor, on the step's
device when the step is a tensor."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.full_like(_step(step), lr)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        frac = torch.clamp(_step(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return lr * (final_frac + (1 - final_frac) * cos)
    return fn


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine_decay(lr, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step):
        step = _step(step)
        warm = lr * step / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm,
                           cos(step - warmup_steps))
    return fn
