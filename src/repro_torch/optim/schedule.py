"""Learning-rate schedules (warmup + cosine / constant / rsqrt).

Each schedule maps a step (an int or a 0-d tensor) to the learning rate as
a 0-d float32 CPU tensor, computed in float32 in the JAX package's order, so
the optimizer sees the reference's float32 value.
"""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "warmup_rsqrt", "constant"]


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.tensor(x, dtype=torch.float32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_ratio: float = 0.1):
    def schedule(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_ratio + (1 - final_ratio) * 0.5 * (1 + torch.cos(
            math.pi * frac))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)
    return schedule


def warmup_rsqrt(peak_lr: float, warmup_steps: int):
    def schedule(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        decay = peak_lr * torch.sqrt(warmup_steps
                                     / torch.clamp_min(step, 1.0))
        return torch.where(step < warmup_steps, warm, decay)
    return schedule


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)
