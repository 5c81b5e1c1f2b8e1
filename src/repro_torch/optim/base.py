"""Minimal optimizer framework (port of ``repro/optim/base.py``).

An ``Optimizer`` is (init, update):
    state   = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params  = apply_updates(params, updates)

State is a plain dict: {"step": int32 scalar tensor, "slots": <per-leaf
dicts mirroring the param tree>} — the structure the upcycling surgery
maps (core/upcycle.upcycle_opt_state).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.models.param import tree_leaves, tree_zip_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, new_state)


def apply_updates(params, updates):
    return tree_zip_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))
