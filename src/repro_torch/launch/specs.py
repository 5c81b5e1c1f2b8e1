"""Dry-run cells: step functions and their inputs on the meta device (no
allocation) for every (architecture x input shape x mesh x profile)
combination (port of ``repro/launch/specs.py``).

The reference builds ``ShapeDtypeStruct`` stand-ins with shardings
attached and lowers the program GSPMD partitions over the mesh. The
port builds the same inputs as tensors on the meta device and a step
that runs on them through the kernels' shape-only route
(``kernels/ops.py``): ``launch/dryrun.py`` runs it once under
``launch/flops.step_cost``. A mesh here is a ``{axis: size}`` mapping
(``launch/mesh.production_mesh_shape``); it sets the placements
(``make_ctx``, the rules of ``sharding/logical.py``) that the dry run's
per-device bytes read. Building a cell starts no process group, and the
step is the global one on one device: its FLOPs are the whole mesh's.
Asked for ``rank``, under a process group spanning the mesh, the cell
is rank 0's own step on its blocks (the dry run's memory record).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, ArchConfig, ShapeCfg, get_config
from repro_torch.models import model_zoo as zoo
from repro_torch.models import param as pm
from repro_torch.optim import adafactor, inverse_sqrt
from repro_torch.sharding import (
    ShardCtx,
    _make_groups,
    _map,
    make_rules,
    mesh_shape,
    serve_layout,
    shard_leaf,
    train_layout,
)
from repro_torch.training.train_loop import (
    TrainConfig,
    init_train_state,
    make_train_step,
)

BIG_PARAM_THRESHOLD = 2e10  # >20B params -> bf16 weights for training
WHISPER_ENC_FRAMES = 3000
PIXTRAL_PATCHES = 1024

BATCH_AXES = {
    "tokens": "batch seq",
    "targets": "batch seq",
    "dec_tokens": "batch seq",
    "enc_tokens": "batch seq",
    "frames": "batch seq embed",
    "patch_embeds": "batch seq embed",
    "labels": "batch",
}


@dataclasses.dataclass(frozen=True)
class Profile:
    name: str
    dispatch: str
    ce_chunk: int
    fsdp: bool  # shard weight `embed` dims over `data` (beyond-paper)
    remat: str = "full"
    act_overrides: Optional[dict] = None
    param_overrides: Optional[dict] = None
    fsdp_over_pod: bool = False
    pad_heads_multiple: int = 0


PROFILES = {
    # Paper-faithful: DP + TP + expert partitioning, GShard one-hot einsum
    # dispatch, full logits (no weight-FSDP in 2022 T5X MoE).
    "baseline": Profile("baseline", dispatch="einsum", ce_chunk=0,
                        fsdp=False),
    # Beyond-paper: FSDP weights, gather dispatch, chunked CE, head-padding
    # TP for indivisible head counts (qwen2.5's 40 heads).
    "optimized": Profile("optimized", dispatch="gather", ce_chunk=2048,
                         fsdp=True, pad_heads_multiple=16),
    # Inference-only weight-stationary layout: expert weights shard
    # (E -> model, F -> data) and stay resident, the MoE's partial
    # outputs summed over data and model (core/moe.py); dense d_ff shards
    # over model (classic TP). Served by ServeEngine(ctx=make_ctx(...)).
    "serve_tp": Profile(
        "serve_tp", dispatch="gather", ce_chunk=0, fsdp=False,
        pad_heads_multiple=16,
        param_overrides={
            "embed": (),
            "mlp": (("model",), ("data",)),
        },
    ),
}


def count_params(cfg: ArchConfig) -> tuple[int, int]:
    """(total, active) parameter counts from the parameters built on the
    meta device (no allocation). An expert leaf counts min(k, E) / E of
    its elements active, k the router's top-k (its capacity factor for
    Expert Choice)."""
    params = zoo.init_params(None, cfg, device="meta")
    total = active = 0
    moe = cfg.moe
    for leaf in pm.tree_leaves(params):
        n = leaf.numel()
        total += n
        if moe is not None and "expert" in pm.axes_of(leaf).split():
            k = moe.top_k if moe.router in ("top_k", "switch") \
                else moe.capacity_factor
            active += int(n * min(k, moe.num_experts) / moe.num_experts)
        else:
            active += n
    return total, active


def make_ctx(mesh, cfg: ArchConfig, profile: Profile) -> ShardCtx:
    """The cell's rules on ``mesh``, and the process groups where a
    process group spanning the mesh is initialised (so that
    ``ServeEngine(ctx=make_ctx(mesh, cfg, PROFILES["serve_tp"]))`` serves
    on every rank, as the reference's engine takes any ``ShardCtx``);
    none in the dry run."""
    overrides = dict(cfg.sharding_overrides or {})
    overrides.update(profile.param_overrides or {})
    act_overrides = dict(profile.act_overrides or {})
    groups = {}
    if dist.is_available() and dist.is_initialized() and \
            math.prod(mesh_shape(mesh).values()) == dist.get_world_size():
        groups = _make_groups(mesh)
    return ShardCtx(
        mesh=mesh,
        act_rules=make_rules(mesh, params=False, overrides=act_overrides),
        param_rules=make_rules(
            mesh, params=True,
            dp_only=not profile.fsdp,
            fsdp_over_pod=profile.fsdp_over_pod,
            overrides=overrides,
        ),
        groups=groups,
    )


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_struct(cfg: ArchConfig, shape: ShapeCfg) -> dict:
    """The reference's model inputs of a cell, as meta tensors."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if cfg.structure == "encoder_decoder":
        dec = S // 4 if shape.kind == "train" else S
        enc = S if shape.kind == "train" else WHISPER_ENC_FRAMES
        b = {"dec_tokens": _meta((B, dec), i32)}
        if shape.kind == "train":
            b["targets"] = _meta((B, dec), i32)
        if cfg.frontend == "frame":
            b["frames"] = _meta((B, enc, cfg.d_model), bf16)
        else:
            b["enc_tokens"] = _meta((B, enc), i32)
        return b
    b = {"tokens": _meta((B, S), i32)}
    if shape.kind == "train":
        b["targets"] = _meta((B, S), i32)
    if cfg.frontend == "patch":
        b["patch_embeds"] = _meta((B, min(PIXTRAL_PATCHES, S), cfg.d_model),
                                  bf16)
    return b


def batch_axes(batch_struct: dict) -> dict:
    return {k: BATCH_AXES[k] for k in batch_struct}


def build_cell(
    arch: str,
    shape: Union[str, ShapeCfg],
    mesh,
    *,
    profile: str = "baseline",
    extra_ac: Optional[dict] = None,
    cfg: Optional[ArchConfig] = None,
    param_dtype: Optional[torch.dtype] = None,
    cache_dtype: Optional[torch.dtype] = None,
    rank: bool = False,
):
    """Returns (step_fn, args on the meta device, info dict). ``shape``
    is a ``SHAPES`` name or a ``ShapeCfg`` of one's own. ``info`` adds
    the cell's ``ctx`` (:func:`make_ctx`), ``cfg``, ``ac`` (its
    ``ApplyCfg``) and the inputs' logical axes (``axes``, mirroring
    ``args``) to the reference's keys.

    Train cells take the train state from ``init_train_state`` (float32
    weights, bf16 above :data:`BIG_PARAM_THRESHOLD`) and the default
    Adafactor, the WKV through its plain chunked version as the train
    launcher runs it (the kernel is forward-only); prefill and decode
    cells take bf16 weights and the static engine's serve cache, a
    decode step one new token at position S - 1; their steps run under
    the cell's ctx, as the reference's do (it has no process groups, so
    the step is the global one).

    ``cfg`` (the arch's config cut or changed), ``param_dtype`` and
    ``cache_dtype`` override the cell's. ``rank``: rank 0's own step
    under a process group spanning the mesh (``launch/dryrun``'s rank
    step, on a "fake" group): a train cell's state cut to the rank's
    blocks by ``sharding.train_layout`` and its rows of the batch, the
    step ``make_train_step(layout=)``; a serving cell's weights cut to
    the rank's blocks under the param rules and placed inside the step
    (``ServeLayout.place``: the joins over their FSDP dims counted as
    the step's, as the reference's program gathers them), its rows of
    the batch or tokens and its block of the cache
    (``serve_layout``); ``info["global_args"]`` the global inputs. On a
    mesh of one the rank's step is the global one; on a larger mesh
    without the process group it raises."""
    from repro_torch.training.train_loop import state_axes

    cfg = cfg if cfg is not None else get_config(arch)
    shp = SHAPES[shape] if isinstance(shape, str) else shape
    prof = PROFILES[profile]
    ctx = make_ctx(mesh, cfg, prof)
    total, active = count_params(cfg)

    ac_kw = dict(
        compute_dtype="bfloat16",
        remat=prof.remat,
        dispatch=prof.dispatch,
        ce_chunk=prof.ce_chunk,
        pad_heads_multiple=prof.pad_heads_multiple,
    )
    ac_kw.update(extra_ac or {})
    info = {
        "arch": arch, "shape": shp.name, "profile": profile,
        "params_total": total, "params_active": active,
        "seq_len": shp.seq_len, "global_batch": shp.global_batch,
        "kind": shp.kind, "cfg": cfg, "ctx": ctx,
    }

    if shp.kind == "train":
        ac = zoo.ApplyCfg(**{"mixer_impl": "eager", **ac_kw})
        if param_dtype is None:
            param_dtype = (torch.bfloat16 if total > BIG_PARAM_THRESHOLD
                           else torch.float32)
        info["param_dtype"] = str(param_dtype).split(".")[1]
        opt = adafactor(inverse_sqrt(peak=0.01, warmup_steps=10_000))
        tc = TrainConfig()
        state = init_train_state(None, cfg, opt, dtype=param_dtype, tc=tc,
                                 device="meta")
        batch = _batch_struct(cfg, shp)
        info["axes"] = (state_axes(cfg, dtype=param_dtype, tc=tc),
                        batch_axes(batch))
        info["ac"] = ac
        info["global_args"] = (state, batch)
        layout = _rank_layout(rank, ctx, mesh, lambda: train_layout(
            ctx, cfg, ac.dispatch, state))
        if layout is None:
            return make_train_step(cfg, opt, ac=ac, tc=tc), (state, batch), \
                info
        i, n = layout.batch_rows()
        return (make_train_step(cfg, opt, ac=ac, tc=tc, layout=layout),
                (layout.shard(state), _rows(batch, i, n)), info)

    # Serving cells: bf16 weights and cache by default.
    ac = info["ac"] = zoo.ApplyCfg(**{**ac_kw, "remat": "none",
                                      "ce_chunk": 0})
    param_dtype = param_dtype or torch.bfloat16
    cache_dtype = cache_dtype or torch.bfloat16
    params = zoo.init_params(None, cfg, dtype=param_dtype, device="meta")
    p_axes = zoo.param_axes(cfg)
    info["param_dtype"] = str(param_dtype).split(".")[1]
    B, S = shp.global_batch, shp.seq_len
    enc_len = WHISPER_ENC_FRAMES if cfg.structure == "encoder_decoder" \
        else 0

    def fresh_cache():
        return zoo.init_serve_cache(cfg, B, S, dtype=cache_dtype,
                                    device="meta", enc_len=enc_len)

    # The global cache's shapes, for the rank's layout (on the card too
    # a meta tensor: ``ServeEngine.static_cache``).
    shapes = fresh_cache()
    lay = _rank_layout(rank, ctx, mesh, lambda: serve_layout(
        ctx, cfg, cache=shapes))
    if lay is not None:
        blocks = _map(lambda t, s: shard_leaf(t, s, ctx), params, lay.specs)
        i, n = lay.rows()
    if shp.kind == "prefill":
        batch = _batch_struct(cfg, shp)
        info["axes"] = (p_axes, batch_axes(batch))
        info["global_args"] = (params, batch)
        if lay is None:
            def prefill_step(params, batch):
                return zoo.prefill(params, batch, fresh_cache(), cfg, ac=ac,
                                   ctx=ctx)

            return prefill_step, (params, batch), info

        def prefill_rank(blocks, batch):
            return zoo.prefill(lay.place(blocks), batch,
                               lay.alloc(shapes, device="meta"), cfg,
                               ac=ac, ctx=lay.ctx)

        return prefill_rank, (blocks, _rows(batch, i, n)), info

    tokens = _meta((B, 1), torch.int32)
    info["axes"] = (p_axes, "batch seq", zoo.serve_cache_axes(cfg), None)
    info["global_args"] = (params, tokens, shapes, S - 1)
    if lay is None:
        def serve_step(params, tokens, cache, index):
            return zoo.decode_step(params, tokens, cache, index, cfg, ac=ac,
                                   ctx=ctx)

        return serve_step, info["global_args"], info

    def decode_rank(blocks, tokens, cache, index):
        return zoo.decode_step(lay.place(blocks), tokens, cache, index, cfg,
                               ac=ac, ctx=lay.ctx)

    return decode_rank, (blocks, _rows(tokens, i, n), lay.alloc(
        shapes, device="meta"), S - 1), info


def _rank_layout(rank: bool, ctx: ShardCtx, mesh, make):
    """The rank's layout (``make()``) for a ``rank`` cell on a mesh of
    more than one device; None for the global step (``rank`` False, or a
    mesh of one, whose rank's step is the global one). Raises where the
    ctx has no process groups: a rank's step is never the global one on
    a larger mesh."""
    if not rank or math.prod(mesh_shape(mesh).values()) == 1:
        return None
    if not ctx.groups:
        raise RuntimeError(
            "a rank's step needs a process group spanning the mesh "
            f"{dict(mesh_shape(mesh))} (init_process_group with its world "
            "size)")
    return make()


def _rows(tree, i: int, n: int):
    """Block ``i`` of ``n`` of every leaf's rows, each a copy of its own
    (a rank's rows, as the card's step receives them)."""
    def one(t):
        per = t.shape[0] // n
        return t[i * per:(i + 1) * per].clone()

    return {k: one(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else one(tree)


def input_specs(arch: str, shape_name: str = "train_4k", mesh=None,
                profile: str = "baseline"):
    """Meta-tensor stand-ins for every model input of a cell: the
    positional argument tuple of the cell's step function (train:
    (state, batch); prefill: (params, batch); decode: (params, tokens,
    cache, index))."""
    if mesh is None:
        from repro_torch.launch.mesh import production_mesh_shape

        mesh = production_mesh_shape()
    _, args, _ = build_cell(arch, shape_name, mesh, profile=profile)
    return args
