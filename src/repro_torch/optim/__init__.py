"""Optimizers and LR schedules (port of ``repro/optim``): Adafactor, the
paper's optimizer, AdamW and SGD with momentum, and the constant,
inverse-sqrt, vision (``rsqrt_with_cooldown``) and cosine schedules."""
from repro_torch.optim.adafactor import adafactor  # noqa: F401
from repro_torch.optim.adamw import adamw, sgd  # noqa: F401
from repro_torch.optim.schedules import (  # noqa: F401
    constant,
    cosine,
    inverse_sqrt,
    rsqrt_with_cooldown,
)
