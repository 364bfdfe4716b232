"""Learning-rate schedules (functions of the step counter), copies of
``repro.optim.schedules`` in float32: each returns a 0-d float32 CPU
tensor, the value the reference's ``jnp`` arithmetic gives."""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


def cosine_lr(step, *, peak: float, warmup: int, total: int,
              floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``floor_frac * peak``."""
    step = _f32(step)
    warm = peak * (step + 1.0) / max(warmup, 1)        # nonzero at step 0
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    floor = floor_frac * peak
    cos = floor + (peak - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup, warm, cos)


def wsd_lr(step, *, peak: float, warmup: int, total: int,
           decay_frac: float = 0.1, floor_frac: float = 0.01
           ) -> torch.Tensor:
    """Warmup-Stable-Decay (MiniCPM): flat plateau, late sharp decay."""
    step = _f32(step)
    decay_start = total * (1.0 - decay_frac)
    warm = peak * (step + 1.0) / max(warmup, 1)
    frac = torch.clamp((step - decay_start)
                       / max(total - decay_start, 1), 0, 1)
    floor = floor_frac * peak
    dec = peak * _f32(floor / peak) ** frac          # exponential decay leg
    return torch.where(step < warmup, warm,
                       torch.where(step < decay_start, _f32(peak), dec))


def make_schedule(name: str, *, peak: float = 3e-4, warmup: int = 100,
                  total: int = 10_000):
    if name == "wsd":
        return lambda s: wsd_lr(s, peak=peak, warmup=warmup, total=total)
    return lambda s: cosine_lr(s, peak=peak, warmup=warmup, total=total)
