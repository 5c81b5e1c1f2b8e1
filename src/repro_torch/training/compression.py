"""Gradient compression with error feedback (port of
``repro/training/compression.py``):

    c = Q(g + e);  e' = (g + e) - c

``bf16`` rounds to bfloat16 and back; ``int8`` quantises each leaf to
127 levels of its largest magnitude, rounding half to even
(``torch.round``, as ``jnp.round``), in the reference's order of
operations — ``x / scale``, round, clip, ``* scale`` — so the CPU
results are those of the reference's jitted step bit for bit. The residual tree lives in the
train state (``state["residual"]``, float32, the params' key paths), so
it checkpoints and restores with everything else, in either package.
"""
from __future__ import annotations

import torch

from repro_torch.models.param import tree_map, tree_zip_map
from repro_torch.optim.adafactor import _pick
from repro_torch.optim.base import leaf_max

KINDS = ("none", "bf16", "int8")


def init_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress(grads, residual, kind: str, groups=None):
    """Returns (compressed-then-decompressed grads, new residual).
    ``groups``: each leaf's ``LeafShard``, as the optimizers take it
    (int8's scale is the whole leaf's largest magnitude)."""
    if kind == "none":
        return grads, residual
    if groups is None:
        groups = tree_map(lambda _: None, grads)

    def one(g, e, shard):
        x = g.to(torch.float32) + e
        if kind == "bf16":
            c = x.to(torch.bfloat16).to(torch.float32)
        elif kind == "int8":
            scale = torch.clamp(leaf_max(x.abs(), shard), min=1e-12) / 127.0
            q = torch.clamp(torch.round(x / scale), -127, 127)
            c = q * scale
            # The residual x - q * scale rounded once, as XLA contracts
            # the reference's jitted multiply and subtract into one FMA:
            # in float64 the product (a 7-bit level times a float32
            # scale) and the difference are exact.
            e = (x.double() - q.double() * scale.double()).to(x.dtype)
            return c.to(g.dtype), e
        else:
            raise ValueError(f"unknown compression {kind!r}")
        return c.to(g.dtype), x - c

    both = tree_zip_map(one, grads, residual, groups)
    return _pick(both, 0), _pick(both, 1)
