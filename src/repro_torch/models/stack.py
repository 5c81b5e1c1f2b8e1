"""Layer stacks: descriptors, segment detection and the layer loop (port
of ``repro/models/stack.py``).

Params of each segment position are stacked over repeats with a leading
axis, exactly the JAX layout (``stack/segments/<i>/pos<j>/...``). JAX
scans over that axis; the port walks it with a Python loop, taking
per-layer views (gradients flow back into the stacked leaves). Caches
are stacked the same way: per-layer KV pools are slices of one ``(reps,
P, bs, Kh, dh)`` tensor per position, the static engine's KV caches and
RWKV states slices of ``(reps, B, ...)`` tensors, all written in place.
Without a cache the stack runs the training forward, optionally under
remat (``remat="full"|"dots"|"moe"``): each repeat of a segment's layer
pattern — the reference's scan body — runs under
``torch.utils.checkpoint``, saving what the policy names and recomputing
the rest in the backward.

Mixers: attention, mamba (``models/ssm.py``: jamba's layers) and
RWKV-6 time-mix (with its channel-mix wrapper ``cm`` around the FFN). A
mamba layer's recurrence is a Python loop over positions inside the
layer, so under remat it runs inside the checkpointed body; its per-step
``bmm`` products are batched, so ``"dots"`` recomputes them (as the
reference's ``dots_with_no_batch_dims_saveable``). A decoder layer
of an encoder-decoder model (``desc.cross``) adds cross-attention onto
the encoder states (``cross_norm``, ``cross``) between its mixer and
its FFN.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs import ArchConfig
from repro_torch.core.moe import moe_apply, moe_init
from repro_torch.models import rwkv, ssm
from repro_torch.models.attention import (
    CACHE_AXES,
    attention_apply,
    attention_init,
    init_cache as attn_cache_init,
    init_paged_cache,
)
from repro_torch.models.layers import mlp_apply, mlp_init, norm_apply, norm_init
from repro_torch.models.param import (
    axes_of,
    tag,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


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


def layer_init(gen, cfg: ArchConfig, desc: LayerDesc, *,
               dtype=torch.float32, device=None):
    kw = dict(dtype=dtype, device=device)
    p = {"pre_norm": norm_init(cfg, device=device)}
    if desc.mixer == "attn":
        p["mixer"] = attention_init(gen, cfg, **kw)
    elif desc.mixer == "mamba":
        p["mixer"] = ssm.mamba_init(gen, cfg, **kw)
    elif desc.mixer == "rwkv6":
        p["mixer"] = rwkv.time_mix_init(gen, cfg, **kw)
    else:
        raise ValueError(desc.mixer)
    if desc.cross:
        p["cross_norm"] = norm_init(cfg, device=device)
        p["cross"] = attention_init(gen, cfg, **kw)
    p["ffn_norm"] = norm_init(cfg, device=device)
    if desc.mixer == "rwkv6":
        p["cm"] = rwkv.channel_mix_init(gen, cfg, **kw)
    if desc.ffn == "moe":
        p["ffn"] = moe_init(gen, cfg, cfg.moe, **kw)
    else:
        p["ffn"] = mlp_init(gen, cfg, **kw)
    return p


def layer_cache_init(cfg: ArchConfig, desc: LayerDesc, batch: int,
                     max_len: int, *, dtype=torch.bfloat16, device=None):
    """The static engine's cache of one layer: the dense KV cache of an
    attention layer, the conv window and SSM state of a mamba layer, the
    time-mix and channel-mix states of an rwkv6 layer."""
    kw = dict(dtype=dtype, device=device)
    if desc.mixer == "attn":
        return {"mixer": attn_cache_init(cfg, batch, max_len, **kw)}
    if desc.mixer == "mamba":
        return {"mixer": ssm.mamba_cache_init(cfg, batch, **kw)}
    return {"mixer": rwkv.time_mix_cache_init(cfg, batch, **kw),
            "cm": rwkv.channel_mix_cache_init(cfg, batch, **kw)}


def layer_cache_axes(desc: LayerDesc):
    """The logical axes of :func:`layer_cache_init`'s cache."""
    if desc.mixer == "attn":
        return {"mixer": dict(CACHE_AXES)}
    if desc.mixer == "mamba":
        return {"mixer": dict(ssm.MAMBA_CACHE_AXES)}
    return {"mixer": dict(rwkv.TIME_MIX_CACHE_AXES),
            "cm": dict(rwkv.CHANNEL_MIX_CACHE_AXES)}


def zero_metrics(device=None):
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("aux_loss", "z_loss", "dropped_frac_sum",
                      "moe_layer_count")}


def layer_apply(p, x, cfg: ArchConfig, desc: LayerDesc, *, enc=None,
                cache=None, cache_index=None, block_tables=None,
                token_mask=None, mixed=None, causal: bool = True,
                mode: str = "train", router_kind: str = "top_k",
                dispatch: str = "gather", moe_impl: str = "auto",
                attn_impl: str = "auto", mixer_impl: str = "auto",
                tag_moe: bool = False, pad_heads_multiple: int = 0,
                ctx=None):
    """One pre-norm layer: the training forward over (B, S, d) when
    ``cache`` is None (``causal`` False for encoders); with a cache, the
    static engine's prefill or decode step (``block_tables`` None) or
    the paged serve step (prefill-on-join or single-token rows).
    ``mode`` (train | prefill | decode, as the reference's) is read by
    a mamba mixer only, whose prefill and decode steps differ. A
    ``desc.cross`` layer then attends onto the encoder states ``enc``
    (B, Se, d), uncached. An rwkv6 layer gates its FFN output with the
    channel-mix receptance. ``tag_moe`` tags a MoE layer's output as
    the ``remat="moe"`` boundary. ``pad_heads_multiple`` pads the
    attention's query heads (``attention.pad_heads``). ``ctx`` (a
    ``ShardCtx``) reaches the attention, the rwkv time mix, the mamba
    mixer, the MLP and the MoE layer: each runs tensor parallel on the
    ``model`` blocks its weights hold (``sharding/comm.params_for_compute``,
    ``ServeLayout.place``), the MoE expert-parallel under ``moe.ep ==
    "a2a"`` with the sorted dispatch. Returns (x, metrics, cache), the cache
    updated in place."""
    h = norm_apply(p["pre_norm"], x, cfg)
    mix_cache = None if cache is None else cache["mixer"]
    if desc.mixer == "attn":
        y, _ = attention_apply(
            p["mixer"], h, cfg, cache=mix_cache, cache_index=cache_index,
            block_tables=block_tables, mixed=mixed, causal=causal,
            implementation=attn_impl, pad_heads_multiple=pad_heads_multiple,
            ctx=ctx,
        )
    elif desc.mixer == "mamba":
        y, _ = ssm.mamba_apply(p["mixer"], h, cfg, cache=mix_cache,
                               mode=mode, ctx=ctx)
    else:
        y, _ = rwkv.time_mix_apply(p["mixer"], h, cfg, cache=mix_cache,
                                   implementation=mixer_impl, ctx=ctx)
    x = x + y
    if desc.cross:
        hc = norm_apply(p["cross_norm"], x, cfg)
        yc, _ = attention_apply(p["cross"], hc, cfg, kv_x=enc,
                                implementation=attn_impl,
                                pad_heads_multiple=pad_heads_multiple,
                                ctx=ctx)
        x = x + yc
    h = norm_apply(p["ffn_norm"], x, cfg)
    gate = None
    if "cm" in p:
        h, gate, _ = rwkv.channel_mix_pre(
            p["cm"], h, cache=None if cache is None else cache["cm"])
    metrics = {}  # a dense layer adds nothing to zero_metrics()
    if desc.ffn == "moe":
        y, m = moe_apply(
            p["ffn"], h, cfg, cfg.moe, router_kind=router_kind,
            dispatch=dispatch, implementation=moe_impl,
            token_mask=token_mask, tag=tag_moe, ctx=ctx,
        )
        metrics = {"aux_loss": m["aux_loss"], "z_loss": m["z_loss"],
                   "dropped_frac_sum": m["dropped_frac"],
                   "moe_layer_count": torch.ones_like(m["aux_loss"])}
        if ctx is not None:
            metrics["ep_overflow_frac_sum"] = m["ep_overflow_frac"]
    else:
        y = mlp_apply(p["ffn"], h, cfg, ctx)
    if gate is not None:
        y = gate * y
    return x + y, metrics, cache


def _stack_trees(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def stack_init(gen, cfg: ArchConfig, descs, *, dtype=torch.float32,
               device=None):
    """Layer params stacked over each segment's repeats. Each layer is
    drawn in order and copied into its slot of the stacked leaves, so
    the stack never holds a second copy of itself (rwkv6-7b is 30 GB in
    float32). A stacked leaf's logical axes lead with ``layer``."""
    out = []
    for reps, pdescs in find_segments(descs):
        seg = {}
        for r in range(reps):
            for i, d in enumerate(pdescs):
                layer = layer_init(gen, cfg, d, dtype=dtype, device=device)
                if r == 0:
                    seg[f"pos{i}"] = tree_map(
                        lambda t: tag(t.new_empty((reps, *t.shape)),
                                      "layer " + axes_of(t)), layer)
                for dst, src in zip(tree_leaves(seg[f"pos{i}"]),
                                    tree_leaves(layer)):
                    dst[r].copy_(src)
                del layer
        out.append(seg)
    return {"segments": out}


def stack_cache_init(cfg: ArchConfig, descs, batch: int, max_len: int, *,
                     dtype=torch.bfloat16, device=None):
    """The static engine's caches, stacked over segment repeats."""
    out = []
    for reps, pdescs in find_segments(descs):
        seg = {}
        for i, d in enumerate(pdescs):
            one = layer_cache_init(cfg, d, batch, max_len, dtype=dtype,
                                   device=device)
            seg[f"pos{i}"] = tree_map(
                lambda v: v[None].repeat(reps, *([1] * v.dim())), one)
        out.append(seg)
    return {"segments": out}


def stack_cache_axes(descs):
    """The logical axes of :func:`stack_cache_init`'s caches."""
    return {"segments": [
        {f"pos{i}": tree_map(lambda a: f"layer {a}", layer_cache_axes(d))
         for i, d in enumerate(pdescs)}
        for _, pdescs in find_segments(descs)]}


def stack_paged_cache_init(cfg: ArchConfig, descs, num_blocks: int,
                           block_size: int, *, dtype=torch.bfloat16,
                           device=None):
    """One KV block pool per layer, stacked over segment repeats; every
    layer's pool is addressed by the SAME per-slot block table."""
    out = []
    for reps, pdescs in find_segments(descs):
        seg = {}
        for i, d in enumerate(pdescs):
            if d.mixer != "attn":
                raise ValueError(
                    "paged serving supports attention mixers only, got "
                    f"{d.mixer!r} (serve it through the static engine)")
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


REMAT = ("none", "full", "dots", "moe")


def _policy(saved, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(remat: str):
    """The checkpoint's ``context_fn`` for a policy: "full" saves nothing
    inside the body; "dots" the outputs of the dense matmuls without
    batch dimensions (``aten.mm``, ``aten.addmm``: the reference's
    ``dots_with_no_batch_dims_saveable``); "moe" only the tagged MoE
    output. The CUDA kernels sit behind ``torch.autograd.Function``s over
    pybind calls, not dispatcher ops, so no policy can save their
    outputs: every policy recomputes them."""
    if remat == "full":
        return None
    saved = ({torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
             if remat == "dots"
             else {torch.ops.repro_torch.moe_block.default})
    return functools.partial(create_selective_checkpoint_contexts,
                             functools.partial(_policy, saved))


def stack_apply(params, x, cfg: ArchConfig, descs, *, enc=None,
                cache=None, cache_index=None, block_tables=None,
                token_mask=None, mixed=None, causal: bool = True,
                mode: str = "train", router_kind: str = "top_k",
                dispatch: str = "gather", moe_impl: str = "auto",
                attn_impl: str = "auto", mixer_impl: str = "auto",
                remat: str = "none", pad_heads_multiple: int = 0,
                ctx=None):
    """Apply every layer in order: the training forward when ``cache``
    is None (bidirectional when ``causal`` is False), else the static
    engine's prefill or decode step (``block_tables`` None; ``mode``
    "prefill" or "decode", which a mamba layer reads) or the paged
    serve step, with the caches in ``cache`` updated in place. ``enc``:
    the encoder states a decoder stack's cross-attention reads.

    ``remat`` in none|full|dots|moe (the training forward under
    autograd only): one repeat of a segment's layer pattern at a time
    runs under ``torch.utils.checkpoint`` (non-reentrant) with the
    policy of :func:`_remat_context`. ``find_segments`` makes the ViT's
    6 dense + 6 MoE layers one 12-layer body, as in the reference. The
    layers' metrics come out of the body as they would without it.
    ``pad_heads_multiple`` and ``ctx`` go to every layer
    (:func:`layer_apply`); with a ``ctx`` the metrics add
    ``ep_overflow_frac_sum`` over the MoE layers.

    Returns (x, summed metrics, cache)."""
    if remat not in REMAT:
        raise ValueError(f"unknown remat {remat!r} {REMAT}")
    remat = (remat if cache is None and torch.is_grad_enabled()
             else "none")
    totals = zero_metrics(x.device)
    if ctx is not None:
        totals["ep_overflow_frac_sum"] = torch.zeros((), device=x.device)
    for si, (reps, pdescs) in enumerate(find_segments(descs)):
        seg_params = {k: _per_layer(v, reps)
                      for k, v in params["segments"][si].items()}
        for r in range(reps):
            def body(h, r=r, si=si, pdescs=pdescs, seg_params=seg_params):
                ms = []
                for i, d in enumerate(pdescs):
                    take = lambda t: t[r]  # noqa: E731
                    layer_cache = None if cache is None else tree_map(
                        take, cache["segments"][si][f"pos{i}"])
                    h, m, _ = layer_apply(
                        seg_params[f"pos{i}"][r], h, cfg, d, enc=enc,
                        cache=layer_cache, cache_index=cache_index,
                        block_tables=block_tables, token_mask=token_mask,
                        mixed=mixed, causal=causal, mode=mode,
                        router_kind=router_kind, dispatch=dispatch,
                        moe_impl=moe_impl, attn_impl=attn_impl,
                        mixer_impl=mixer_impl, tag_moe=remat == "moe",
                        pad_heads_multiple=pad_heads_multiple, ctx=ctx,
                    )
                    ms.append(m)
                return h, ms

            if remat == "none":
                x, ms = body(x)
            else:
                context = _remat_context(remat)
                x, ms = checkpoint(
                    body, x, use_reentrant=False,
                    **({} if context is None else {"context_fn": context}))
            for m in ms:
                for k, v in m.items():
                    totals[k] = totals[k] + v
    return x, totals, cache
