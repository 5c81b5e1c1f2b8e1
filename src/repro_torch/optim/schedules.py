"""LR schedules (port of ``repro/optim/schedules.py``: the constant and
the inverse-sqrt schedules; the vision recipe's and cosine are queued in
ROADMAP.md). Each returns f(step: int tensor) -> float32 lr tensor.

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
