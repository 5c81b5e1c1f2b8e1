"""Conversion between the JAX package's parameter values tree (as numpy
arrays) and the port's tree of tensors.

The JAX side is ``pm.split(zoo.init_params(...))[0]`` with every leaf
turned into a numpy array; key paths, list positions (layer-stack
segments) and shapes are kept exactly. This module imports no jax:
bfloat16 leaves (numpy's ``ml_dtypes`` bfloat16) cross as their raw
16-bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.param import tree_map


def _to_tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_jax_values(tree, *, device="cpu", dtype=None):
    """numpy values tree (JAX key paths) -> tensor tree on ``device``.
    ``dtype`` optionally casts floating leaves."""
    return tree_map(lambda a: _to_tensor(a, device, dtype), tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # numpy has no bfloat16 without ml_dtypes: widen exactly.
        t = t.float()
    return t.numpy()


def to_jax_values(tree):
    """Tensor tree -> numpy values tree with the same key paths
    (bfloat16 leaves widen exactly to float32)."""
    return tree_map(_to_numpy, tree)
