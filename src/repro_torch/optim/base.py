"""Minimal optimizer framework (port of ``repro/optim/base.py``).

An ``Optimizer`` is (init, update):
    state   = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params  = apply_updates(params, updates)

State is a plain dict: {"step": int32 scalar tensor, "slots": <per-leaf
dicts mirroring the param tree>} — the structure the upcycling surgery
maps (core/upcycle.upcycle_opt_state).

Sharded leaves: ``update(..., groups=)`` takes a tree mirroring the
params whose leaf is the :class:`LeafShard` of a leaf (None: the rank
holds the whole leaf): its spec over the mesh, and its slots'. Every
statistic taken over a whole leaf (:func:`leaf_sum`, :func:`leaf_max`,
:func:`global_norm`) reduces over every axis the leaf lies on, one taken
over some dims (Adafactor's row and column means) over those dims'
axes, so a rank holding a block of a leaf steps as the single-device
optimizer steps the whole leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.models.param import tree_leaves, tree_zip_map


class Optimizer(NamedTuple):
    init: Callable
    # (grads, state, params, groups=None) -> (updates, new_state)
    update: Callable


@dataclasses.dataclass(frozen=True, eq=False)
class LeafShard:
    """How a leaf lies over the mesh (``ctx``, a ``ShardCtx``):
    ``spec``, one entry a dim (None, an axis, a tuple of axes); and
    ``slots``, the spec the state holds each optimizer slot in (the
    reference's ``state_axes`` placement, which may shard a slot's dim
    that the leaf's spec leaves whole)."""

    ctx: Any
    spec: tuple
    slots: dict = dataclasses.field(default_factory=dict)

    def _axes(self, dims=None) -> tuple:
        from repro_torch.sharding import entry_axes

        spec = self.spec
        dims = range(len(spec)) if dims is None else dims
        used = {a for d in dims if -len(spec) <= d < len(spec)
                for a in entry_axes(spec[d])}
        return tuple(a for a in self.ctx.shape if a in used)

    def group(self, dims=None):
        """The group over the axes of ``dims`` (all the leaf's by
        default; None when they span one rank)."""
        return self.ctx.group(self._axes(dims))

    def size(self, dims=None) -> int:
        return self.ctx.size(self._axes(dims))

    def slot_in(self, name: str, t: torch.Tensor, like: tuple):
        """A slot as the state holds it -> laid out as ``like`` (the
        spec its update computes in)."""
        from repro_torch.sharding import reshard

        return reshard(t, self.slots.get(name, like), like, self.ctx)

    def slot_out(self, name: str, t: torch.Tensor, like: tuple):
        from repro_torch.sharding import reshard

        return reshard(t, like, self.slots.get(name, like), self.ctx)


def _group(shard: Optional[LeafShard], dims=None):
    return None if shard is None else shard.group(dims)


def leaf_sum(x: torch.Tensor, shard: Optional[LeafShard] = None,
             dims=None) -> torch.Tensor:
    """The sum of a whole leaf of which ``x`` is this rank's block; with
    ``dims``, the sums over those dims (kept) of the whole leaf."""
    from repro_torch.sharding import all_reduce

    if dims is None:
        return all_reduce(torch.sum(x), _group(shard))
    return all_reduce(torch.sum(x, dim=dims, keepdim=True),
                      _group(shard, dims))


def leaf_max(x: torch.Tensor, shard: Optional[LeafShard] = None):
    from repro_torch.sharding import all_reduce

    return all_reduce(torch.max(x), _group(shard), op="max")


def leaf_numel(x: torch.Tensor, shard: Optional[LeafShard] = None,
               dims=None) -> int:
    import math

    n = x.numel() if dims is None else math.prod(x.shape[d] for d in dims)
    return n * (1 if shard is None else shard.size(dims))


def leaf_mean(x: torch.Tensor, shard: Optional[LeafShard] = None,
              dims=None) -> torch.Tensor:
    """The mean of a whole leaf (``torch.mean`` when unsharded); with
    ``dims`` (negative), the means over those dims, squeezed."""
    if shard is None:
        return torch.mean(x) if dims is None else torch.mean(x, dim=dims)
    s = leaf_sum(x, shard, dims) / leaf_numel(x, shard, dims)
    return s if dims is None else s.squeeze(dims)


def apply_updates(params, updates):
    return tree_zip_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree, groups=None) -> torch.Tensor:
    """The l2 norm over every leaf; ``groups`` as ``update`` takes it."""
    leaves = tree_leaves(tree)
    gs = [None] * len(leaves) if groups is None else tree_leaves(groups)
    return torch.sqrt(sum(leaf_sum(torch.square(x.float()), g)
                          for x, g in zip(leaves, gs)))
