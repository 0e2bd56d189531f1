"""Learning-rate schedules (port of ``repro/optim/schedules.py``): pure
functions of the step counter, a 0-d int tensor, computed in fp32 on its
device (no host sync)."""
from __future__ import annotations

import math

import torch


def linear_warmup(peak: float, warmup_steps: int):
    def fn(step):
        s = step.float()
        return peak * torch.clamp(s / max(warmup_steps, 1), max=1.0)
    return fn


def cosine_schedule(peak: float, warmup_steps: int, total_steps: int,
                    floor: float = 0.1):
    def fn(step):
        s = step.float()
        warm = peak * torch.clamp(s / max(warmup_steps, 1), max=1.0)
        frac = torch.clamp((s - warmup_steps) /
                           max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(s < warmup_steps, warm, peak * cos)
    return fn
