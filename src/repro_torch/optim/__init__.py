"""Optimizers and LR schedules (port of ``repro/optim``): Adafactor,
the paper's optimizer, and the schedules. AdamW and SGD are queued in
ROADMAP.md."""
from repro_torch.optim.adafactor import adafactor  # noqa: F401
from repro_torch.optim.schedules import constant, inverse_sqrt  # noqa: F401
