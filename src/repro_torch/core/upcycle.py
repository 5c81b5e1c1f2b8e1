"""The sparse-upcycling surgery (port of ``repro/core/upcycle.py``;
paper §3, Figure 1).

``upcycle_params`` maps a trained dense checkpoint onto the sparse
target architecture: every parameter is copied verbatim except the MLPs
of layers that become MoE, which are replicated into each expert;
routers are new, drawn from a ``torch.Generator`` (normal, std 0.02,
§A.1.1) unless the caller hands them in (the parity tests pass the JAX
draws). ``upcycle_opt_state`` carries the dense optimizer slots across
(§B.6), ``depth_tile`` is the dense-upcycling baseline (Fig. 5).

The functions work on plain values trees (the port has no ``Param``
wrapper) and return new tensors; the dense tree is left as it was.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ArchConfig, MoECfg
from repro_torch.core.moe import moe_init
from repro_torch.core.routing import router_init
from repro_torch.models import stack as stk
from repro_torch.models.param import tree_leaves, tree_map


def _unstack(stack_tree, descs) -> list:
    """Segment-stacked tree -> one tree per layer (views), in order."""
    layers = []
    for si, (reps, pdescs) in enumerate(stk.find_segments(descs)):
        seg = stack_tree["segments"][si]
        for r in range(reps):
            for i in range(len(pdescs)):
                layers.append(tree_map(lambda t, r=r: t[r], seg[f"pos{i}"]))
    return layers


def _restack(layers, descs):
    """Inverse of :func:`_unstack` (new, stacked tensors)."""
    it = iter(layers)
    out = []
    for reps, pdescs in stk.find_segments(descs):
        per_pos = {f"pos{i}": [] for i in range(len(pdescs))}
        for _ in range(reps):
            for i in range(len(pdescs)):
                per_pos[f"pos{i}"].append(next(it))
        out.append({k: stk._stack_trees(v) for k, v in per_pos.items()})
    return {"segments": out}


def _tile_expert(v: torch.Tensor, num_experts: int, gen,
                 noise_std: float) -> torch.Tensor:
    t = v[None].expand(num_experts, *v.shape).clone()
    if noise_std:
        t += noise_std * torch.randn(t.shape, generator=gen, dtype=t.dtype,
                                     device=t.device)
    return t


def _expand_ffn(dense_ffn, cfg: ArchConfig, moe: MoECfg, gen, router):
    """Dense MLP params {wi[,wg],wo} -> MoE params {router, experts}."""
    device = dense_ffn["wi"].device
    if router is None:
        router = router_init(gen, cfg.d_model, moe, device=device)["w"]
    elif not isinstance(router, torch.Tensor):
        router = torch.tensor(np.asarray(router))
    if moe.expert_init == "random":
        # Ablation §B.5: experts from scratch.
        experts = moe_init(gen, cfg, moe, dtype=dense_ffn["wi"].dtype,
                           device=device)["experts"]
    else:
        noise = moe.init_noise_std if moe.expert_init == "copy_noise" else 0.0
        experts = {k: _tile_expert(v, moe.num_experts, gen, noise)
                   for k, v in sorted(dense_ffn.items())}
    return {"router": {"w": torch.as_tensor(router, device=device)},
            "experts": experts}


def upcycle_params(dense_params, dense_cfg: ArchConfig,
                   target_cfg: ArchConfig, gen=None, *,
                   routers: Optional[Sequence] = None):
    """Dense values tree -> sparse values tree (Figure 1). The layers
    that become MoE are those of ``target_cfg``'s layer pattern (every
    other, all, or the last half, which splits the stack into a dense
    and a MoE segment).

    ``gen``: a ``torch.Generator`` (or int seed) on the params' device
    for the routers (and for expert noise / random experts). ``routers``:
    optional per-layer router weights ``(d, E)``, indexed by layer, to
    use instead of fresh draws."""
    moe = target_cfg.moe
    if moe is None:
        raise ValueError("target config has no MoE section")
    if target_cfg.structure not in ("decoder_only", "encoder_only"):
        raise NotImplementedError(
            "the port upcycles decoder-only and encoder-only stacks (the "
            "encoder-decoder family is queued in ROADMAP.md)")
    dense_descs = stk.layer_descs(dense_cfg)
    target_descs = stk.layer_descs(target_cfg)
    if len(dense_descs) != len(target_descs):
        raise ValueError(
            f"layer count mismatch: dense {len(dense_descs)} vs "
            f"target {len(target_descs)}")
    if gen is None or isinstance(gen, int):
        device = tree_leaves(dense_params)[0].device
        gen = torch.Generator(device=device).manual_seed(gen or 0)
    out = []
    layers = _unstack(dense_params["stack"], dense_descs)
    for l, (dl, dd, td) in enumerate(zip(layers, dense_descs, target_descs)):
        if dd.mixer != td.mixer or dd.cross != td.cross:
            raise ValueError(f"layer {l}: incompatible descs {dd} vs {td}")
        new = dict(dl)
        if td.ffn == "moe" and dd.ffn == "dense":
            new["ffn"] = _expand_ffn(
                dl["ffn"], target_cfg, moe, gen,
                None if routers is None else routers[l])
        elif td.ffn != dd.ffn:
            raise ValueError(f"layer {l}: cannot map {dd.ffn} -> {td.ffn}")
        out.append(new)
    params = {k: tree_map(torch.clone, v) for k, v in dense_params.items()
              if k != "stack"}
    params["stack"] = _restack(out, target_descs)
    return params


def upcycle_opt_state(sparse_fresh_state, dense_state,
                      dense_cfg: ArchConfig, target_cfg: ArchConfig):
    """Carry dense optimizer slots into the upcycled model (§B.6).

    ``sparse_fresh_state``: ``optimizer.init(upcycled_params)``; router
    slots keep their fresh values (paper footnote 6). Slots of MLPs that
    became experts are broadcast over the new leading expert dim
    (Adafactor factors over the last two dims, so a dense (d,) v_row
    tiles to (E, d) exactly). The dense step counter is kept: the paper
    continues the LR schedule where the dense run left off (§4.1)."""
    dense_slots = dense_state["slots"]
    slots = dict(sparse_fresh_state["slots"])
    for key in dense_slots:
        if key != "stack":
            slots[key] = tree_map(torch.clone, dense_slots[key])
    ddescs = stk.layer_descs(dense_cfg)
    tdescs = stk.layer_descs(target_cfg)
    dlayers = _unstack(dense_slots["stack"], ddescs)
    flayers = _unstack(sparse_fresh_state["slots"]["stack"], tdescs)
    merged = []
    for dl, fl, dd, td in zip(dlayers, flayers, ddescs, tdescs):
        new = dict(dl)
        if td.ffn == "moe" and dd.ffn == "dense":
            E = target_cfg.moe.num_experts
            new["ffn"] = {
                "router": fl["ffn"]["router"],  # fresh
                "experts": tree_map(
                    lambda v: v[None].expand(E, *v.shape), dl["ffn"]),
            }
        merged.append(new)
    slots["stack"] = _restack(merged, tdescs)
    return {"step": dense_state["step"].clone(), "slots": slots}


def depth_tile(dense_params, dense_cfg: ArchConfig, factor: int):
    """Dense upcycling / depth tiling baseline (Fig. 5; Rae et al. 2021):
    whole-network replication [L1..Ln, L1..Ln, ...]. Returns (tiled
    params, deeper ArchConfig)."""
    descs = stk.layer_descs(dense_cfg)
    layers = _unstack(dense_params["stack"], descs)
    target_cfg = dataclasses.replace(
        dense_cfg, n_layers=dense_cfg.n_layers * factor,
        name=f"{dense_cfg.name}-depth{factor}x")
    params = {k: tree_map(torch.clone, v) for k, v in dense_params.items()
              if k != "stack"}
    params["stack"] = _restack(layers * factor,
                               stk.layer_descs(target_cfg))
    return params, target_cfg
