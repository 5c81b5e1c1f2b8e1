"""LR schedules (port of ``repro/optim/schedules.py``). Each returns
f(step: int tensor) -> float32 lr tensor.

The paper continues the dense checkpoint's inverse-sqrt schedule "where
it left off" (§4.1): the train state carries the absolute step, so an
upcycled model resumes the schedule with no discontinuity.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def inverse_sqrt(peak: float = 0.01, warmup_steps: int = 10_000):
    """T5 schedule: lr = peak * sqrt(warmup) / sqrt(max(step, warmup))."""

    def f(step):
        s = torch.clamp(_f32(step), min=float(warmup_steps))
        return peak * math.sqrt(float(warmup_steps)) / torch.sqrt(s)

    return f


def rsqrt_with_cooldown(
    peak: float = 4e-4,
    warmup_steps: int = 10_000,
    timescale: int = 100_000,
    cooldown_start: int = 0,
    cooldown_steps: int = 50_000,
):
    """Vision schedule (paper §A.1.2): linear warmup, reverse-sqrt decay
    with a timescale, final linear cooldown to 0."""

    def f(step):
        s = _f32(step)
        warm = torch.clamp(s / max(warmup_steps, 1), max=1.0)
        decay = torch.sqrt(
            timescale / torch.clamp(s + timescale - warmup_steps,
                                    min=float(timescale)))
        lr = peak * warm * decay
        if cooldown_start > 0:
            frac = torch.clamp(
                (s - cooldown_start) / max(cooldown_steps, 1), 0.0, 1.0)
            lr = lr * (1.0 - frac)
        return lr

    return f


def cosine(peak: float, total_steps: int, warmup_steps: int = 0,
           floor: float = 0.0):
    def f(step):
        s = _f32(step)
        warm = (torch.clamp(s / max(warmup_steps, 1), max=1.0)
                if warmup_steps else 1.0)
        prog = torch.clamp(
            (s - warmup_steps) / max(total_steps - warmup_steps, 1),
            0.0, 1.0)
        return floor + (peak - floor) * warm * 0.5 * (
            1.0 + torch.cos(math.pi * prog))

    return f
