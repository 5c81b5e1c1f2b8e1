"""Layer stacks: descriptors, segment detection and the layer loop (port
of ``repro/models/stack.py``).

Params of each segment position are stacked over repeats with a leading
axis, exactly the JAX layout (``stack/segments/<i>/pos<j>/...``). JAX
scans over that axis; the port walks it with a Python loop, taking
per-layer views (gradients flow back into the stacked leaves). Per-layer
KV pools are slices of one ``(reps, P, bs, Kh, dh)`` tensor per
position, written in place. Without a cache the stack runs the dense
training forward.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.moe import moe_apply, moe_init
from repro_torch.models.attention import (
    attention_apply,
    attention_init,
    init_paged_cache,
)
from repro_torch.models.layers import mlp_apply, mlp_init, norm_apply, norm_init
from repro_torch.models.param import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    mixer: str  # attn | mamba | rwkv6
    ffn: str  # dense | moe
    cross: bool = False


def layer_descs(cfg: ArchConfig, *, stack: str = "decoder") -> list[LayerDesc]:
    n = cfg.n_encoder_layers if stack == "encoder" else cfg.n_layers
    cross = stack == "decoder" and cfg.structure == "encoder_decoder"
    descs = []
    for l in range(n):
        if stack == "encoder" or cfg.attn_pattern == "all":
            mixer = "attn"
        elif cfg.attn_pattern == "none":
            mixer = "rwkv6"
        elif cfg.attn_pattern == "jamba":
            mixer = "attn" if l % 8 == 4 else "mamba"
        else:
            raise ValueError(cfg.attn_pattern)
        ffn = "dense"
        if cfg.moe is not None:
            pat = cfg.moe.layer_pattern
            if pat == "all":
                ffn = "moe"
            elif pat == "every_other":
                ffn = "moe" if l % 2 == 1 else "dense"
            elif pat == "last_half":
                ffn = "moe" if l >= n - n // 2 else "dense"
            elif pat != "none":
                raise ValueError(pat)
        descs.append(LayerDesc(mixer=mixer, ffn=ffn, cross=cross))
    return descs


def stack_router_kind(cfg: ArchConfig, *, stack: str) -> str:
    """Paper §3.1: Expert Choice in encoders, Top-K in decoders."""
    if cfg.moe is None:
        return "top_k"
    if stack == "decoder" and cfg.moe.router == "expert_choice":
        return "top_k"
    return cfg.moe.router


def find_segments(descs: list[LayerDesc]) -> list[tuple[int, list[LayerDesc]]]:
    """-> [(repeats, period_descs), ...]; greedy smallest-period split."""
    n = len(descs)
    if n == 0:
        return []
    for p in range(1, n + 1):
        if n % p:
            continue
        if all(descs[i] == descs[i % p] for i in range(n)):
            return [(n // p, descs[:p])]
    half = n // 2
    return find_segments(descs[:half]) + find_segments(descs[half:])


def _check_desc(desc: LayerDesc) -> None:
    if desc.mixer != "attn" or desc.cross:
        raise NotImplementedError(
            f"layer {desc} is not ported yet: the port runs attention "
            "stacks (mamba/rwkv6/cross-attention are queued in ROADMAP.md)"
        )


def layer_init(gen, cfg: ArchConfig, desc: LayerDesc, *,
               dtype=torch.float32, device=None):
    _check_desc(desc)
    kw = dict(dtype=dtype, device=device)
    p = {"pre_norm": norm_init(cfg, device=device),
         "mixer": attention_init(gen, cfg, **kw),
         "ffn_norm": norm_init(cfg, device=device)}
    if desc.ffn == "moe":
        p["ffn"] = moe_init(gen, cfg, cfg.moe, **kw)
    else:
        p["ffn"] = mlp_init(gen, cfg, **kw)
    return p


def zero_metrics(device=None):
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("aux_loss", "z_loss", "dropped_frac_sum",
                      "moe_layer_count")}


def layer_apply(p, x, cfg: ArchConfig, desc: LayerDesc, *, cache=None,
                cache_index=None, block_tables=None, token_mask=None,
                mixed=None, causal: bool = True, router_kind: str = "top_k",
                dispatch: str = "gather", moe_impl: str = "auto",
                attn_impl: str = "auto"):
    """One pre-norm layer: the dense training forward over (B, S, d)
    when ``cache`` is None (``causal`` False for encoders), else paged
    single-token rows. Returns (x, metrics, cache)."""
    h = norm_apply(p["pre_norm"], x, cfg)
    y, mix_cache = attention_apply(
        p["mixer"], h, cfg, cache=None if cache is None else cache["mixer"],
        cache_index=cache_index, block_tables=block_tables, mixed=mixed,
        causal=causal, implementation=attn_impl,
    )
    x = x + y
    h = norm_apply(p["ffn_norm"], x, cfg)
    metrics = {}  # a dense layer adds nothing to zero_metrics()
    if desc.ffn == "moe":
        y, m = moe_apply(
            p["ffn"], h, cfg, cfg.moe, router_kind=router_kind,
            dispatch=dispatch, implementation=moe_impl,
            token_mask=token_mask,
        )
        metrics = {"aux_loss": m["aux_loss"], "z_loss": m["z_loss"],
                   "dropped_frac_sum": m["dropped_frac"],
                   "moe_layer_count": torch.ones_like(m["aux_loss"])}
    else:
        y = mlp_apply(p["ffn"], h, cfg)
    return x + y, metrics, None if cache is None else {"mixer": mix_cache}


def _stack_trees(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def stack_init(gen, cfg: ArchConfig, descs, *, dtype=torch.float32,
               device=None):
    out = []
    for reps, pdescs in find_segments(descs):
        per_pos = {f"pos{i}": [] for i in range(len(pdescs))}
        for _ in range(reps):
            for i, d in enumerate(pdescs):
                per_pos[f"pos{i}"].append(
                    layer_init(gen, cfg, d, dtype=dtype, device=device)
                )
        out.append({k: _stack_trees(v) for k, v in per_pos.items()})
    return {"segments": out}


def stack_paged_cache_init(cfg: ArchConfig, descs, num_blocks: int,
                           block_size: int, *, dtype=torch.bfloat16,
                           device=None):
    """One KV block pool per layer, stacked over segment repeats; every
    layer's pool is addressed by the SAME per-slot block table."""
    out = []
    for reps, pdescs in find_segments(descs):
        seg = {}
        for i, d in enumerate(pdescs):
            _check_desc(d)
            one = init_paged_cache(cfg, num_blocks, block_size,
                                   dtype=dtype, device=device)
            seg[f"pos{i}"] = {"mixer": {
                k: v[None].repeat(reps, *([1] * v.dim()))
                for k, v in one.items()
            }}
        out.append(seg)
    return {"segments": out}


def _per_layer(tree, reps: int) -> list:
    """Per-layer views of a stacked tree, through ONE unbind per leaf:
    its backward stacks the layers' gradients once, where indexing each
    layer would add a full-size gradient into the stacked leaf per
    layer."""
    unbound = [t.unbind(0) for t in tree_leaves(tree)]
    return [tree_unflatten(tree, [u[r] for u in unbound])
            for r in range(reps)]


def stack_apply(params, x, cfg: ArchConfig, descs, *, cache=None,
                cache_index=None, block_tables=None, token_mask=None,
                mixed=None, causal: bool = True, router_kind: str = "top_k",
                dispatch: str = "gather", moe_impl: str = "auto",
                attn_impl: str = "auto"):
    """Apply every layer in order: the training forward when ``cache``
    is None (bidirectional when ``causal`` is False), else the paged
    serve step with the pools in ``cache`` updated in place. Returns
    (x, summed metrics, cache)."""
    totals = zero_metrics(x.device)
    for si, (reps, pdescs) in enumerate(find_segments(descs)):
        seg_params = {k: _per_layer(v, reps)
                      for k, v in params["segments"][si].items()}
        for r in range(reps):
            for i, d in enumerate(pdescs):
                take = lambda t: t[r]  # noqa: E731
                layer_cache = None if cache is None else tree_map(
                    take, cache["segments"][si][f"pos{i}"])
                x, m, _ = layer_apply(
                    seg_params[f"pos{i}"][r], x, cfg, d,
                    cache=layer_cache, cache_index=cache_index,
                    block_tables=block_tables, token_mask=token_mask,
                    mixed=mixed, causal=causal, router_kind=router_kind,
                    dispatch=dispatch, moe_impl=moe_impl,
                    attn_impl=attn_impl,
                )
                for k, v in m.items():
                    totals[k] = totals[k] + v
    return x, totals, cache
