"""The train step and train state (port of ``make_train_step``,
``init_train_state`` and the step fields of ``TrainConfig`` in
``repro/training/train_loop.py``).

``make_train_step`` builds ``train_step(state, batch[, lr_scale]) ->
(state, metrics)``: loss and gradients through autograd (the flash and
grouped-GEMM backward kernels on a CUDA device), the optimizer update,
the non-finite guard and the optional LR scale, with no host sync — the
metrics stay on the device until the caller reads them. Where the JAX
step is functional and donates its input state, this one updates the
parameter tensors IN PLACE and returns the new state dict; the caller
drops the old one, as it would have dropped the donated JAX state.

Gradient accumulation, gradient compression, remat and the Trainer
runtime are queued in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import model_zoo as zoo
from repro_torch.models.param import tree_leaves, tree_unflatten, tree_zip_map
from repro_torch.optim.base import Optimizer, global_norm


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The step's fields of the reference's ``TrainConfig`` (the port's
    step runs ``grad_accum=1`` and ``compression="none"``)."""

    # Non-finite loss guard: a NaN/inf loss or grad norm skips the
    # optimizer update (params and opt state keep their old values, the
    # step counter still advances). 0 disables the guard.
    max_consecutive_skips: int = 10


def batch_to(batch: dict, device) -> dict:
    """numpy (or tensor) batch -> tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(device) for k, v in batch.items()}


def loss_and_grads(params, batch, cfg: ArchConfig, *,
                   ac: zoo.ApplyCfg = zoo.ApplyCfg()):
    """(grads tree, metrics) of ``zoo.loss_fn`` at ``params`` — the
    port of ``jax.value_and_grad(loss_fn, has_aux=True)``; the metrics
    include ``loss`` and ``ce``. ``params`` is left as it was."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, mets = zoo.loss_fn(params, batch, cfg, ac=ac)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (tree_unflatten(params, grads),
            {k: v.detach() for k, v in mets.items()})


def make_train_step(cfg: ArchConfig, optimizer: Optimizer, *,
                    ac: zoo.ApplyCfg = zoo.ApplyCfg(),
                    tc: TrainConfig = TrainConfig()):
    """Returns ``train_step(state, batch, lr_scale=None) -> (state,
    metrics)``. ``ac``'s "auto" implementations resolve by the params'
    device when the step runs. ``lr_scale`` (optional scalar tensor)
    multiplies the optimizer updates."""

    @torch.no_grad()
    def train_step(state, batch, lr_scale=None):
        params = state["params"]
        device = tree_leaves(params)[0].device
        grads, mets = loss_and_grads(params, batch_to(batch, device), cfg,
                                     ac=ac)
        updates, opt_state = optimizer.update(
            grads, state["opt_state"], params)
        grad_norm = global_norm(grads)
        mets["grad_norm"] = grad_norm
        if tc.max_consecutive_skips > 0:
            ok = torch.isfinite(mets["loss"]) & torch.isfinite(grad_norm)
            mets["skipped"] = (~ok).to(torch.float32)
        else:
            ok = torch.ones((), dtype=torch.bool, device=device)
            mets["skipped"] = torch.zeros((), device=device)

        def apply(p, u):
            if lr_scale is not None:
                u = u * lr_scale
            p.copy_(torch.where(ok, (p + u).to(p.dtype), p))

        tree_zip_map(apply, params, updates)
        # The guard keeps the old optimizer state (its step included).
        opt_state = tree_zip_map(lambda new, old: torch.where(ok, new, old),
                                 opt_state, state["opt_state"])
        new_state = dict(state)
        new_state.update(opt_state=opt_state, step=state["step"] + 1)
        return new_state, mets

    return train_step


def init_train_state(gen, cfg: ArchConfig, optimizer: Optimizer, *,
                     dtype=torch.float32, params: Any = None, device=None):
    """``params``: optional pre-built values tree (e.g. upcycled), used
    as it is; otherwise ``zoo.init_params(gen, cfg)``."""
    if params is None:
        params = zoo.init_params(gen, cfg, dtype=dtype, device=device)
    device = tree_leaves(params)[0].device
    return {
        "params": params,
        "opt_state": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }

