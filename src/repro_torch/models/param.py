"""Parameter initializers and tree helpers (port of
``repro/models/param.py``, reduced to what the port needs).

Parameter trees are plain nested dicts (and lists, for layer-stack
segments) of tensors with the JAX key paths. There is no ``Param``
wrapper: each initializer takes the leaf's logical axes (the
reference's space-joined names, one a dim) and records them on the
tensor it returns (:func:`tag`), so ``model_zoo.param_axes`` reads the
axes tree off a parameter tree built on the meta device. The axes feed
the sharding rules (``repro_torch/sharding``).
"""
from __future__ import annotations

import math

import torch


def tag(t: torch.Tensor, axes: str) -> torch.Tensor:
    """Record ``axes`` (space-joined logical names, one a dim) on ``t``
    and return it."""
    if len(axes.split()) != t.dim():
        raise ValueError(f"axes {axes!r} rank != tensor rank {tuple(t.shape)}")
    t.logical_axes = axes
    return t


def axes_of(t: torch.Tensor) -> str:
    return t.logical_axes


def dense(gen: torch.Generator, shape, axes: str, *, dtype=torch.float32,
          device=None, fan_in: int | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init (lecun_normal-style): a standard
    normal truncated to [-2, 2], scaled by ``1 / sqrt(fan_in)``."""
    if fan_in is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    v = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return tag((v * std).to(dtype), axes)


def normal(gen: torch.Generator, shape, axes: str, *, std=0.02,
           dtype=torch.float32, device=None) -> torch.Tensor:
    v = torch.empty(shape, dtype=torch.float32, device=device)
    v.normal_(0.0, 1.0, generator=gen)
    return tag((v * std).to(dtype), axes)


def full(shape, value: float, axes: str, *, dtype=torch.float32,
         device=None) -> torch.Tensor:
    return tag(torch.full(shape, value, dtype=dtype, device=device), axes)


def ones(shape, axes: str, *, dtype=torch.float32,
         device=None) -> torch.Tensor:
    return full(shape, 1.0, axes, dtype=dtype, device=device)


def zeros(shape, axes: str, *, dtype=torch.float32,
          device=None) -> torch.Tensor:
    return full(shape, 0.0, axes, dtype=dtype, device=device)


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a dict/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_zip_map(fn, tree, *others):
    """Apply ``fn(leaf, *others_at_leaf)`` over ``tree``'s structure;
    each of ``others`` mirrors ``tree`` down to its leaves (where it may
    hold any object, e.g. an optimizer's per-leaf slot dict)."""
    if isinstance(tree, dict):
        return {k: tree_zip_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_zip_map(fn, v, *(o[i] for o in others))
                          for i, v in enumerate(tree))
    return fn(tree, *others)


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` in the order of
    :func:`tree_leaves`."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def count_params(values) -> int:
    return sum(int(v.numel()) for v in tree_leaves(values))
