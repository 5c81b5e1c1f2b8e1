"""Minimal optimizer framework (port of ``repro/optim/base.py``).

An ``Optimizer`` is (init, update):
    state   = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params  = apply_updates(params, updates)

State is a plain dict: {"step": int32 scalar tensor, "slots": <per-leaf
dicts mirroring the param tree>} — the structure the upcycling surgery
maps (core/upcycle.upcycle_opt_state).

Sharded leaves: ``update(..., groups=)`` takes a tree mirroring the
params whose leaf is the process group a leaf's slices lie over (None:
the rank holds the whole leaf). Every statistic taken over a whole leaf
(:func:`leaf_sum`, :func:`leaf_max`, :func:`global_norm`) reduces over
that group, so a rank holding ``E / ep`` experts of a leaf steps as the
single-device optimizer steps the whole leaf.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.models.param import tree_leaves, tree_zip_map


class Optimizer(NamedTuple):
    init: Callable
    # (grads, state, params, groups=None) -> (updates, new_state)
    update: Callable


def leaf_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of a whole leaf of which ``x`` is this rank's slice."""
    from repro_torch.sharding import all_reduce

    return all_reduce(torch.sum(x), group)


def leaf_max(x: torch.Tensor, group=None) -> torch.Tensor:
    from repro_torch.sharding import all_reduce

    return all_reduce(torch.max(x), group, op="max")


def leaf_numel(x: torch.Tensor, group=None) -> int:
    import torch.distributed as dist

    return x.numel() * (1 if group is None
                        else dist.get_world_size(group))


def leaf_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of a whole leaf (``torch.mean`` when unsharded)."""
    if group is None:
        return torch.mean(x)
    return leaf_sum(x, group) / leaf_numel(x, group)


def apply_updates(params, updates):
    return tree_zip_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree, groups=None) -> torch.Tensor:
    """The l2 norm over every leaf; ``groups`` as ``update`` takes it."""
    leaves = tree_leaves(tree)
    gs = [None] * len(leaves) if groups is None else tree_leaves(groups)
    return torch.sqrt(sum(leaf_sum(torch.square(x.float()), g)
                          for x, g in zip(leaves, gs)))
