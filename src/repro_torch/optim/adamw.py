"""AdamW and SGD with momentum (port of ``repro/optim/adamw.py``; the
modern options beside Adafactor, the paper's optimizer).

Their updates are element-wise (``groups`` is taken and not read: no
statistic spans a leaf). Their state has the reference's key paths — ``{"step", "slots": <per
leaf {"m", "v"} or {"m"}>}`` — so a train state checkpointed by either
package restores in the other.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.param import tree_leaves, tree_map, tree_zip_map
from repro_torch.optim.adafactor import _pick
from repro_torch.optim.base import Optimizer


def _init(params, names):
    f32 = torch.float32
    device = tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "slots": tree_map(lambda p: {n: torch.zeros(p.shape, dtype=f32,
                                                    device=p.device)
                                     for n in names}, params),
    }


def adamw(
    lr: Callable,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    def init(params):
        return _init(params, ("m", "v"))

    def update(grads, state, params, groups=None):
        step = state["step"] + 1
        lr_t = lr(step)
        t = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)

        def upd(g, s, p):
            g = g.to(torch.float32)
            m = b1 * s["m"] + (1 - b1) * g
            v = b2 * s["v"] + (1 - b2) * torch.square(g)
            mh = m / bc1
            vh = v / bc2
            delta = -lr_t * (mh / (torch.sqrt(vh) + eps)
                             + weight_decay * p.to(torch.float32))
            return delta.to(p.dtype), {"m": m, "v": v}

        both = tree_zip_map(upd, grads, state["slots"], params)
        return _pick(both, 0), {"step": step, "slots": _pick(both, 1)}

    return Optimizer(init, update)


def sgd(lr: Callable, *, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return _init(params, ("m",))

    def update(grads, state, params, groups=None):
        step = state["step"] + 1
        lr_t = lr(step)

        def upd(g, s):
            m = momentum * s["m"] + g.to(torch.float32)
            return -lr_t * m, {"m": m}

        both = tree_zip_map(upd, grads, state["slots"])
        return _pick(both, 0), {"step": step, "slots": _pick(both, 1)}

    return Optimizer(init, update)
