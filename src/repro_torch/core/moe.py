"""The MoE layer: router + dispatch + expert FFN + combine (port of
``repro/core/moe.py``). Three dispatches, as in the reference:

* ``"gather"`` (the default) — the padded capacity buffer ``xe (G, E,
  cap, d)`` gathered from the routers' slot tables, through
  ``kernels.ops.expert_ffn`` (the expert-FFN kernels on the card);
* ``"einsum"`` — the same buffer and FFN through one-hot dispatch and
  combine einsums (the GShard-era path);
* ``"sorted"`` — the flat assignment stream stable-sorted by expert
  into a block-aligned ragged buffer ``(G, M, d)`` (M independent of
  the capacity factor) through ``kernels.ops.grouped_mlp``; with
  ``moe.ep == "a2a"`` and a ``ShardCtx`` whose mesh can host it
  (``sharding.expert_parallel_layout``), expert-parallel over the
  mesh's ``model`` ranks (``core/ep.py``), else on this device alone
  with the same results.

Every combine adds each token's rows in a fixed order
(``routing.sum_rows``, ``routing.combine_stream``): no atomic adds, so a
call repeats bit for bit on the card.

The combined output can be tagged with the identity op
``repro_torch::moe_block`` (:func:`moe_block`), the remat boundary that
``stack_apply(remat="moe")``'s policy saves and nothing else (the
reference's ``checkpoint_name(y, "moe_block")``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig, MoECfg
from repro_torch.core import routing as R
from repro_torch.kernels import ops
from repro_torch.kernels.grouped_mlp import ROW_BLOCK, ragged_destinations
from repro_torch.models import param as pm
from repro_torch.sharding import EP_AXIS, comm


@torch.library.custom_op("repro_torch::moe_block", mutates_args=())
def moe_block(y: torch.Tensor) -> torch.Tensor:
    """The remat tag on a MoE layer's combined output: an identity
    dispatcher op, so a selective-checkpoint policy can name it
    (``models/stack.py``). A custom op's output may not alias its input,
    so it copies ``y``: ``moe_apply`` tags only when asked."""
    return y.clone()


@moe_block.register_fake
def _(y):
    return torch.empty_like(y)


moe_block.register_autograd(lambda ctx, dy: dy)


def moe_init(gen, cfg: ArchConfig, moe: MoECfg, *, dtype=torch.float32,
             device=None):
    d, f, E = cfg.d_model, cfg.d_ff, moe.num_experts
    kw = dict(dtype=dtype, device=device)
    experts = {
        "wi": pm.dense(gen, (E, d, f), "expert embed mlp", **kw),
        "wo": pm.dense(gen, (E, f, d), "expert mlp embed", fan_in=f,
                       **kw),
    }
    if cfg.gated_mlp:
        experts["wg"] = pm.dense(gen, (E, d, f), "expert embed mlp",
                                 **kw)
    # The router stays float32, as in the reference.
    return {"router": R.router_init(gen, d, moe, device=device),
            "experts": experts}


def expert_ffn(experts, xe, cfg: ArchConfig, *, implementation="auto"):
    """xe: (G, E, cap, d) -> (G, E, cap, d) through ``ops.expert_ffn``."""
    return ops.expert_ffn(xe, experts["wi"], experts.get("wg"),
                          experts["wo"], act=cfg.act,
                          implementation=implementation)


def _token_major(r: R.Routing) -> bool:
    return r.token_expert is not None


def _gather_dispatch(params, xg, r: R.Routing, cfg: ArchConfig, *,
                     implementation: str):
    """Padded gather dispatch: xe[g, e, c] = xg[g, token_idx[g, e, c]]
    (unfilled slots zero), the expert FFN, then each token's weighted
    rows summed in a fixed order. Token-choice: the slots a row map
    (``R.take_rows`` / ``R.sum_rows``, each token's k slots in the
    order of its choices); Expert Choice: the slot table taken and
    combined expert by expert (``R.take_stream`` / ``R.combine_stream``).
    The backward of each is the other. Returns y (G, g, d)."""
    G, g, d = xg.shape
    E, cap = r.token_idx.shape[1:]
    valid = (r.token_idx < g)[..., None]
    w = (r.combine[..., None] * valid)
    if _token_major(r):
        gi = torch.arange(G, device=xg.device)
        slot = torch.where(
            r.token_expert < E,
            (gi[:, None, None] * E + r.token_expert.long()) * cap
            + r.token_slot, G * E * cap)
        m = R.row_map(slot.reshape(G * g, -1), G * E * cap)
        xe = R.take_rows(xg.reshape(G * g, d), m).reshape(G, E, cap, d)
        ye = expert_ffn(params["experts"], xe, cfg,
                        implementation=implementation)
        yw = (ye * w.to(ye.dtype)).to(xg.dtype).reshape(G * E * cap, d)
        return R.sum_rows(yw, m).reshape(G, g, d)
    tok = r.token_idx.reshape(G, E * cap)
    xe = R.take_stream(xg, tok, E).reshape(G, E, cap, d)
    ye = expert_ffn(params["experts"], xe, cfg,
                    implementation=implementation)
    yw = (ye * w.to(ye.dtype)).to(xg.dtype).reshape(G, E * cap, d)
    return R.combine_stream(yw, tok, g, experts=E)


def _einsum_dispatch(params, xg, r: R.Routing, cfg: ArchConfig, *,
                     implementation: str):
    """One-hot dispatch and combine (the GShard-era faithful path) over
    the same padded buffer and expert FFN. Returns y (G, g, d)."""
    g = xg.shape[1]
    oh = F.one_hot(r.token_idx, g + 1)[..., :g].to(xg.dtype)
    xe = torch.einsum("Gect,Gtd->Gecd", oh, xg)
    ye = expert_ffn(params["experts"], xe, cfg,
                    implementation=implementation)
    comb = oh * r.combine[..., None].to(xg.dtype)
    return torch.einsum("Gect,Gecd->Gtd", comb, ye)


def _sorted_dispatch(params, xg, r: R.Routing, cfg: ArchConfig, *,
                     implementation: str, cap: int | None = None):
    """Sort the flat assignment stream by expert into a ragged buffer
    aligned to the ragged layout's block (:data:`ROW_BLOCK`; results do
    not depend on it): each ragged row taken from its token (a row map
    of the stream's units, ``R.stream_units``), the grouped FFN, each
    row weighted by its assignment's weight and each unit's rows summed
    in stream order (``R.sum_rows``). ``cap``: the routing's capacity;
    with the stream's assignments it bounds a group's valid rows for
    the kernels' meta route.
    Returns y (G, g, d)."""
    G, g, d = xg.shape
    E = r.probs.shape[-1]
    experts = None if _token_major(r) else E
    tok, eid, w = R.assignment_stream(r, E, g)
    valid = (eid < E) & (tok < g)
    key = torch.where(valid, eid, torch.full_like(eid, E)).to(torch.int32)
    perm, _, counts, dest, M = ragged_destinations(key, E, ROW_BLOCK)
    # Each assignment's ragged row (global over the groups), in stream
    # order; G * M where dropped.
    row_of = torch.empty_like(dest, dtype=torch.int64).scatter_(
        1, perm.long(), dest.long())
    gi = torch.arange(G, device=xg.device)[:, None]
    row_of = torch.where(row_of < M, gi * M + row_of, G * M)
    units, A = R.stream_units(xg, tok, experts)
    m = R.row_map(row_of.reshape(-1, A), G * M)
    wr = w.new_zeros(G * M + 1).index_copy(
        0, row_of.reshape(-1), torch.where(valid, w, torch.zeros_like(w))
        .reshape(-1))[:G * M]
    xs = R.take_rows(units, m).reshape(G, M, d)
    ex = params["experts"]
    ys = ops.grouped_mlp(
        xs, ex["wi"], ex.get("wg"), ex["wo"], counts,
        act=cfg.act, block=ROW_BLOCK, implementation=implementation,
        max_rows=None if cap is None else min(E * cap, tok.shape[1]),
    )
    yw = (ys.reshape(G * M, d) * wr[:, None]).to(xg.dtype)
    return R.units_to_tokens(R.sum_rows(yw, m), tok, g, experts)


def _local_routing(r: R.Routing, e0: int, El: int, ctx) -> R.Routing:
    """The routing of this rank's experts ``[e0, e0 + El)`` (all of them
    when ``El`` is the whole count): their slot tables, the token-major
    assignments to them (others marked dropped, ``El``), their probs.
    The combine weights pass :func:`comm.copy_to_model`: each ``model``
    peer's gradient of them holds only its experts' (or its ``mlp``
    block's) part, and the sum over the peers is the whole."""
    kw = {"probs": r.probs[..., e0:e0 + El]}
    if r.token_idx is not None:
        kw["token_idx"] = r.token_idx[:, e0:e0 + El]
        kw["combine"] = comm.copy_to_model(r.combine, ctx)[:, e0:e0 + El]
    if r.token_expert is not None:
        te = r.token_expert
        mine = (te >= e0) & (te < e0 + El)
        kw["token_expert"] = torch.where(mine, te - e0,
                                         torch.full_like(te, El))
        kw["token_weight"] = comm.copy_to_model(r.token_weight, ctx)
    return r._replace(**kw)


def ep_active(ctx, moe: MoECfg) -> bool:
    """Whether the sorted dispatch runs expert-parallel under ``ctx``."""
    from repro_torch.sharding import expert_parallel_layout

    return (ctx is not None and moe.ep == "a2a"
            and expert_parallel_layout(ctx.mesh, moe.num_experts)
            is not None)


def _group(x2d, group_size: int):
    n, d = x2d.shape
    g = min(group_size, n)
    pad = (-n) % g
    if pad:
        x2d = torch.cat([x2d, x2d.new_zeros(pad, d)])
    return x2d.reshape(-1, g, d), n, pad


def _serve_rows(ctx, moe: MoECfg, n: int):
    """Under a serving ctx whose static batch is split over data axes
    (``ServePlan.batch_axes``): the rank's ``[start, stop)`` among the
    global rows where its ``n`` rows do not form whole groups of the
    global batch's routing (a decode step's few rows, a short prefill),
    so the layer must route the global rows, and always under the
    weight-stationary placement (``ServePlan.expert_axes``: a rank's
    block of d_ff serves every row of its data group); None where they
    do (the rank's groups are the global batch's own) or outside
    serving."""
    if ctx is None or not ctx.groups or ctx.serve is None:
        return None
    k = ctx.size(ctx.serve.batch_axes)
    if k == 1 or (not ctx.serve.expert_axes
                  and n % min(moe.group_size, n * k) == 0):
        return None
    i = ctx.index(ctx.serve.batch_axes)
    return i * n, (i + 1) * n


def _expert_axes(ctx) -> tuple:
    """The data axes a serving ctx cuts the experts' d_ff over (the
    weight-stationary placement), () otherwise."""
    if ctx is None or not ctx.groups or ctx.serve is None:
        return ()
    return ctx.serve.expert_axes


def _ep_blocks(params, xg, r: R.Routing, cfg: ArchConfig, moe: MoECfg,
               ctx, own, implementation: str):
    """Expert parallelism under the rules' placement: the rank's rows
    (``xg``, G groups, already through ``comm.copy_to_model``) and their
    routing are the same on every rank over the axes the rows are
    replicated over (``model``; in serving every axis the rows are not
    split over). Each takes its contiguous block of the G groups, runs
    ``core/ep.sorted_dispatch_ep`` on it with its ``E / m`` experts, and
    the blocks are joined again (``comm.gather_blocks``, counted as
    ``ep_all_gather``). The combine weights pass ``comm.copy_to_model``
    before the cut, as the rows did: the peers' zero-padded block
    gradients sum to the whole on every peer, and the join's backward
    keeps the rank's block of a gradient every peer holds whole. The
    global group count must divide the rank count (the reference's
    ``ValueError``)."""
    from repro_torch.core.ep import sorted_dispatch_ep

    if ctx.serve is None:
        rep = (EP_AXIS,)
    else:
        split = ctx.serve.batch_axes if own is None else ()
        rep = tuple(a for a in ctx.shape if a not in split)
    k, G = ctx.size(rep), xg.shape[0]
    if G % k:
        world = ctx.size(ctx.token_axes)
        raise ValueError(
            f"moe.ep='a2a' shards routing groups over all {world} mesh "
            f"devices, but G={G * world // k} groups (tokens/group_size) "
            f"is not divisible — pick batch*seq and group_size so that "
            f"G % {world} == 0")
    n = G // k
    lo = ctx.index(rep) * n

    def cut(t, weights=False):
        if t is None:
            return None
        if weights:
            t = comm.copy_to_model(t, ctx)
        return t[lo:lo + n]

    rb = r._replace(token_idx=cut(r.token_idx),
                    combine=cut(r.combine, True), probs=cut(r.probs),
                    token_expert=cut(r.token_expert),
                    token_weight=cut(r.token_weight, True),
                    token_slot=cut(r.token_slot))
    y, over = sorted_dispatch_ep(params, cut(xg), rb, cfg, moe, ctx=ctx,
                                 implementation=implementation)
    return comm.gather_blocks(y, 0, ctx, rep, "ep_all_gather"), over


def moe_apply(
    params,
    x: torch.Tensor,
    cfg: ArchConfig,
    moe: MoECfg,
    *,
    router_kind: Optional[str] = None,
    dispatch: str = "gather",
    implementation: str = "auto",
    token_mask=None,
    tag: bool = False,
    ctx=None,
):
    """x: (B, S, d) or (N, d). Returns (y, metrics dict).

    ``dispatch``: "gather" | "einsum" (padded capacity buffer through
    the expert FFN) | "sorted" (ragged grouped GEMM); the routing, and
    so the result, is the same for all three.

    ``token_mask``: None, or a bool tensor broadcastable to x's token
    dims — False marks dead tokens (free decode slots, idle chunk
    lanes): they claim no experts, no capacity and no ragged rows, and
    their outputs are zero.

    ``tag``: pass y through :func:`moe_block`, the boundary that
    ``remat="moe"`` saves (off by default: the tag copies y).

    ``ctx``: a ``ShardCtx``. Under the rules' placement (a tensor
    parallel ctx) x holds the data rank's tokens (the same on every
    ``model`` peer) and a sharded router's local logits are gathered so
    that every peer routes alike. With ``dispatch="sorted"``, ``moe.ep
    == "a2a"`` and a mesh that can host expert parallelism, each peer
    then runs ``core/ep.sorted_dispatch_ep`` on its block of the groups
    with its ``E / m`` experts and the blocks are joined
    (:func:`_ep_blocks`); otherwise, where ``params["experts"]`` holds
    the rank's ``E / m`` experts (the reference's expert-resident
    layout) or every expert's block of ``mlp``, each dispatch runs on
    the rank's part (:func:`_local_routing`) and the partial outputs
    are added over ``model``. Under an expert-only ctx (not tensor
    parallel) with expert parallelism, x holds this rank's own tokens
    and the layer runs ``sorted_dispatch_ep`` on them. Under a ctx with
    more than one data rank the rank's tokens must form whole routing
    groups (else ``ValueError``): the single-process step's groups. The
    metrics always hold ``ep_overflow_frac``, 0 outside the
    expert-parallel path.

    Under a serving ctx (``sharding.serve_layout``) the rows of a static
    batch split over data ranks are routed as the global batch's groups:
    where the rank's rows do not form whole global groups they are
    gathered over the data axes, every rank routes the global rows and
    keeps its own (:func:`_serve_rows`); routing local groups would
    change the groups' capacity and which tokens compete. Under the
    weight-stationary placement (``serve_tp``: ``ServePlan.expert_axes``)
    each rank holds its ``E / m`` experts' block of d_ff: it runs either
    dispatch on every row of its data group (a static batch's gathered
    over the data axes, a paged step's already on every rank), and the
    partial outputs are summed over the data axes and ``model``
    (``comm.reduce_over``, ``expert_all_reduce``); a static rank then
    keeps its own rows. Expert parallelism does not run there."""
    dispatches = {"gather": _gather_dispatch, "einsum": _einsum_dispatch,
                  "sorted": _sorted_dispatch}
    if dispatch not in dispatches:
        raise ValueError(f"unknown dispatch {dispatch!r} "
                         f"{tuple(dispatches)}")
    router_kind = router_kind or moe.router
    orig_shape = x.shape
    x2d = x.reshape(-1, x.shape[-1])
    m1 = None
    if token_mask is not None:
        m1 = torch.broadcast_to(token_mask, orig_shape[:-1]).reshape(-1)
        m1 = m1.to(torch.bool)
    own = _serve_rows(ctx, moe, x2d.shape[0])
    if own is not None:
        # The rank's rows are a block of the global batch that does not
        # form whole global groups: route the global rows, keep its own.
        axes = ctx.serve.batch_axes
        x2d = comm.gather_rows(x2d, ctx, axes, "row_all_gather")
        if m1 is not None:
            m1 = comm.gather_rows(m1.to(torch.uint8), ctx, axes,
                                  "row_all_gather").to(torch.bool)
    xg, n, pad = _group(x2d, moe.group_size)
    G, g, d = xg.shape
    mg = None
    if m1 is not None:
        if pad:
            m1 = torch.cat([m1, m1.new_zeros(pad)])
        mg = m1.reshape(G, g)
    ws = _expert_axes(ctx)
    ep = dispatch == "sorted" and ep_active(ctx, moe) and not ws
    ex, E = params["experts"], moe.num_experts
    El = ex["wi"].shape[0]
    # Tensor parallel (the rules' placement): the rank holds El of the E
    # experts, or every expert's block of ``mlp``.
    tp = (ctx is not None and (ctx.tp_size > 1 or bool(ws))
          and (El != E or ex["wi"].shape[-1] != cfg.d_ff))
    if ctx is not None and ctx.groups and not (ep and not tp) \
            and ctx.serve is None and ctx.size(ctx.replica_axes) > 1 \
            and (pad or g != moe.group_size):
        raise ValueError(
            f"the rules shard the batch over "
            f"{ctx.size(ctx.replica_axes)} data ranks, but this rank's {n} "
            f"tokens are not divisible into groups of {moe.group_size}: "
            f"the single-process step would route groups that straddle "
            f"ranks — pick batch*seq and group_size so that each data "
            f"rank holds whole groups")
    w = params["router"]["w"]
    if tp:
        xt = comm.copy_to_model(xg, ctx)
    if w.shape[-1] != E:  # the rank's block of ``expert``
        logits = comm.gather_replicated(xt.float() @ w.float(), -1, ctx)
    else:
        logits = xg.float() @ w.float()
    r = R.route(logits, moe, router_kind, token_mask=mg,
                slot_tables=dispatch != "sorted")
    ep_overflow = logits.new_zeros(())
    if tp and ep:
        y, ep_overflow = _ep_blocks(params, xt, r, cfg, moe, ctx, own,
                                    implementation)
    elif tp:
        kw = {"cap": R.capacity(g, moe)} if dispatch == "sorted" else {}
        y = dispatches[dispatch](
            params, xt, _local_routing(r, ctx.tp_rank * El, El, ctx), cfg,
            implementation=implementation, **kw)
        if own is None and not ws:
            y = comm.reduce_from_model(y, ctx)
    elif ep:
        from repro_torch.core.ep import sorted_dispatch_ep

        if pad or g != moe.group_size:
            raise ValueError(
                f"moe.ep='a2a' shards routing groups over all "
                f"{ctx.size(ctx.token_axes)} mesh ranks, but this rank's "
                f"{n} tokens are not divisible into groups of "
                f"{moe.group_size} — pick batch*seq and group_size so "
                f"that G is divisible by the rank count")
        y, ep_overflow = sorted_dispatch_ep(
            params, xg, r, cfg, moe, ctx=ctx,
            implementation=implementation)
    else:
        kw = {"cap": R.capacity(g, moe)} if dispatch == "sorted" else {}
        y = dispatches[dispatch](params, xg, r, cfg,
                                 implementation=implementation, **kw)
    y = y.reshape(-1, d)
    if pad:
        y = y[:n]
    if tp and ws:
        # Every rank's partial: its experts, its block of d_ff.
        y = comm.reduce_over(y, ctx, ws + (EP_AXIS,), "expert_all_reduce")
    if own is not None:
        y = y[own[0]:own[1]]
        if tp and not ep and not ws:
            y = comm.reduce_from_model(y, ctx)
    y = y.reshape(orig_shape).to(x.dtype)
    if tag:
        y = moe_block(y)
    metrics = {
        "aux_loss": r.aux_loss * moe.aux_loss_weight,
        "z_loss": r.z_loss * moe.z_loss_weight,
        "dropped_frac": r.dropped_frac,
        "router_prob_mean_max": r.probs.max(-1).values.mean(),
        # Assignments dropped by the expert-parallel send budget (0
        # outside that path and whenever the budget holds).
        "ep_overflow_frac": ep_overflow,
    }
    return y, metrics
