"""Learning-rate schedules (counterpart of ``repro.optim.schedules``).

Each schedule maps the optimizer's step count (a 0-d int32 tensor) to a
0-d f32 tensor on the count's device."""
from __future__ import annotations

import math

import torch


def _f32(count) -> torch.Tensor:
    return torch.as_tensor(count, dtype=torch.float32)


def constant(value: float):
    return lambda count: torch.full_like(_f32(count), value)


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    def schedule(count):
        c = _f32(count)
        warm = peak * c / max(warmup_steps, 1)
        progress = torch.clamp((c - warmup_steps)
                               / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1 + torch.cos(math.pi
                                                            * progress))
        return torch.where(c < warmup_steps, warm, cos)
    return schedule


def inverse_sqrt(peak: float, warmup_steps: int):
    def schedule(count):
        c = torch.clamp(_f32(count), min=1.0)
        return peak * torch.minimum(c / warmup_steps,
                                    torch.sqrt(warmup_steps / c))
    return schedule
