"""Adafactor (Shazeer & Stern 2018), the paper's optimizer (§A.1.1,
§A.1.2); port of ``repro/optim/adafactor.py``, t5x-flavoured:

  * factored second moment for leaves whose last two dims are both
    >= ``min_dim_size_to_factor``: row/column running averages over the
    last two dims, leading dims (the stack's layer dim, the expert dim)
    acting as batch dims — which makes optimizer-state upcycling (§B.6)
    a broadcast;
  * decay beta2_t = 1 - t^-0.8;
  * update clipped to RMS threshold 1.0, the RMS taken over the whole
    (stacked) leaf — over every rank's block of a sharded one
    (``groups``, ``optim/base.LeafShard``), as are the factored row
    and column means over a sharded dim;
  * optional multiply-by-parameter-scale, the parameter RMS also over
    the whole stacked leaf (T5 pretraining default);
  * optional momentum (off by default — sublinear memory);
  * decoupled weight decay.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.models.param import tree_leaves, tree_map, tree_zip_map
from repro_torch.optim.base import Optimizer, leaf_mean


def _factored(shape, min_size: int = 128) -> bool:
    """Factor the last two dims only when both are large enough;
    stacked small params (norm scales (layers, d)) stay unfactored, so
    unrelated layers are never coupled."""
    return len(shape) >= 2 and min(shape[-1], shape[-2]) >= min_size


def adafactor(
    lr: Callable,
    *,
    decay_exponent: float = 0.8,
    clip_threshold: float = 1.0,
    eps1: float = 1e-30,
    eps2: float = 1e-3,
    multiply_by_parameter_scale: bool = True,
    beta1: Optional[float] = None,
    weight_decay: float = 0.0,
    min_dim_size_to_factor: int = 128,
) -> Optimizer:
    f32 = torch.float32

    def init(params):
        def slot(p):
            s = {}
            if _factored(p.shape, min_dim_size_to_factor):
                s["v_row"] = torch.zeros(p.shape[:-1], dtype=f32,
                                         device=p.device)
                s["v_col"] = torch.zeros(p.shape[:-2] + p.shape[-1:],
                                         dtype=f32, device=p.device)
            else:
                s["v"] = torch.zeros(p.shape, dtype=f32, device=p.device)
            if beta1 is not None:
                s["m"] = torch.zeros(p.shape, dtype=f32, device=p.device)
            return s

        device = tree_leaves(params)[0].device
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "slots": tree_map(slot, params)}

    def update(grads, state, params, groups=None):
        step = state["step"] + 1
        beta2 = 1.0 - torch.pow(step.to(f32), -decay_exponent)
        lr_t = lr(step)
        if groups is None:
            groups = tree_map(lambda _: None, params)

        def upd(g, s, p, shard):
            g = g.to(f32)
            g2 = torch.square(g) + eps1
            new_s = dict(s)
            if "v_row" in s:  # factored at init, by the whole leaf's shape
                # Each mean over a sharded dim sums over its axes and
                # divides by the whole leaf's count; a slot the state
                # holds in another placement is moved to the update's
                # and back.
                row, col = _slot_specs(shard)
                vr = beta2 * _slot_in(shard, "v_row", s, row) \
                    + (1 - beta2) * leaf_mean(g2, shard, dims=(-1,))
                vc = beta2 * _slot_in(shard, "v_col", s, col) \
                    + (1 - beta2) * leaf_mean(g2, shard, dims=(-2,))
                new_s["v_row"] = _slot_out(shard, "v_row", vr, row)
                new_s["v_col"] = _slot_out(shard, "v_col", vc, col)
                # rank-1 reconstruction of 1/sqrt(v)
                row_mean = leaf_mean(vr, _sub(shard, row), dims=(-1,))
                r = torch.rsqrt(
                    (vr / torch.clamp(row_mean[..., None], min=eps1)
                     )[..., None])
                c = torch.rsqrt(vc)[..., None, :]
                u = g * r * c
            else:
                v = beta2 * s["v"] + (1 - beta2) * g2
                new_s["v"] = v
                u = g * torch.rsqrt(v)
            rms_u = torch.sqrt(leaf_mean(torch.square(u), shard) + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            if beta1 is not None:
                m = beta1 * s["m"] + (1 - beta1) * u
                new_s["m"] = m
                u = m
            scale = lr_t
            if multiply_by_parameter_scale:
                p_rms = torch.sqrt(leaf_mean(torch.square(p.to(f32)),
                                             shard))
                scale = scale * torch.clamp(p_rms, min=eps2)
            delta = -scale * u
            if weight_decay:
                delta = delta - lr_t * weight_decay * p.to(f32)
            return delta.to(p.dtype), new_s

        # Leaves of `both` are (update, slot dict) pairs at param
        # positions; split them.
        both = tree_zip_map(upd, grads, state["slots"], params, groups)
        return _pick(both, 0), {"step": step, "slots": _pick(both, 1)}

    return Optimizer(init, update)


def _slot_specs(shard):
    """The specs ``v_row`` and ``v_col`` are computed in: the leaf's
    without its last dim, without the one before."""
    if shard is None:
        return None, None
    spec = shard.spec
    return spec[:-1], spec[:-2] + spec[-1:]


def _sub(shard, spec):
    return None if shard is None else dataclasses.replace(shard, spec=spec)


def _slot_in(shard, name, s, like):
    return s[name] if shard is None else shard.slot_in(name, s[name], like)


def _slot_out(shard, name, t, like):
    return t if shard is None else shard.slot_out(name, t, like)


def _pick(tree, i: int):
    """Take element ``i`` of every (update, slot) pair leaf."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
