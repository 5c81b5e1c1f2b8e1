"""Routers: Expert Choice, Top-K (with BPR) and Switch (port of
``repro/core/routing.py``).

Routing works on token groups ``(G, g, d)`` with logits ``(G, g, E)``.
Every router returns the padded ``(G, E, cap)`` slot tables the einsum
and gather dispatches consume (``token_idx`` / ``combine``); the
token-choice routers also return the token-major assignment view the
sorted dispatch consumes (``token_expert`` / ``token_weight``), which
holds the same claims, drops and weights. Token-choice callers that run
the sorted dispatch skip the slot tables (``slot_tables=False``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs import MoECfg
from repro_torch.models import param as pm


class Routing(NamedTuple):
    # For every expert slot (G, E, cap): the group-local token that fills
    # it; token id == g marks an unfilled slot. None when the caller
    # asked for no slot tables.
    token_idx: Optional[torch.Tensor]  # int64 (G, E, cap)
    combine: Optional[torch.Tensor]  # f32 (G, E, cap), 0 where unfilled
    probs: torch.Tensor  # (G, g, E) f32 router probabilities
    aux_loss: torch.Tensor  # scalar
    z_loss: torch.Tensor  # scalar
    dropped_frac: torch.Tensor  # scalar
    # Token-choice routers only (None for Expert Choice): (G, g, k) int32
    # expert id per assignment, E marking a dropped or dead assignment,
    # and its combine weight (0 where dropped). Claims and drops are
    # exactly the reference's.
    token_expert: Optional[torch.Tensor] = None
    token_weight: Optional[torch.Tensor] = None
    # Token-choice routers only: (G, g, k) int32 slot of each assignment
    # in its expert's capacity buffer, cap where dropped (the gather
    # dispatch's token-major combine reads it).
    token_slot: Optional[torch.Tensor] = None


def router_init(gen, d_model: int, moe: MoECfg, *, device=None):
    return {"w": pm.normal(gen, (d_model, moe.num_experts), "embed expert",
                           std=moe.router_init_std, device=device)}


def _z_loss(logits) -> torch.Tensor:
    return torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))


def capacity(group: int, moe: MoECfg) -> int:
    """Tokens per expert per group: ``ceil(g * cf / E)``, capped at g.
    Kept as the reference has it: the formula does not scale with top_k
    (ROADMAP.md queue 3)."""
    cap = max(1, -(-int(group * moe.capacity_factor) // moe.num_experts))
    return min(cap, group)


def _scatter_add_groups(tbl, idx, val):
    """tbl (G, g+1); idx (G, E, cap) group-local token ids; val the same
    shape as idx. Returns tbl with val added at each token."""
    G = tbl.shape[0]
    return tbl.scatter_add(1, idx.reshape(G, -1), val.reshape(G, -1))


def _normalize_per_token(token_idx, combine, g: int):
    """Paper §B.7: renormalize each token's combine weights to sum to 1.
    Tokens selected by no expert keep weight 0 (residual passthrough).
    Each token's sum, and its gradient, adds in a fixed order
    (:func:`combine_stream`)."""
    G, E, cap = combine.shape
    tok = token_idx.reshape(G, E * cap)
    denom = combine_stream(combine.reshape(G, E * cap, 1), tok, g,
                           experts=E)
    per_slot = take_stream(torch.clamp(denom, min=1e-9), tok, experts=E)
    return combine / per_slot.reshape(combine.shape)


def route_expert_choice(logits: torch.Tensor, moe: MoECfg) -> Routing:
    """Expert Choice (Zhou et al. 2022): every expert picks its top-cap
    tokens of the group, so every slot is filled and the load is
    balanced by construction (no aux loss)."""
    G, g, E = logits.shape
    cap = capacity(g, moe)
    probs = torch.softmax(logits.float(), dim=-1)
    # lax.top_k over the tokens breaks ties toward the lower token id
    # (the zero-padded tail of the last group has exactly uniform probs);
    # a stable descending sort does the same.
    w, idx = torch.sort(probs.transpose(1, 2), dim=-1, descending=True,
                        stable=True)
    combine, token_idx = w[..., :cap], idx[..., :cap]  # (G, E, cap)
    if moe.normalize_combine_weights:
        combine = _normalize_per_token(token_idx, combine, g)
    sel = _scatter_add_groups(probs.new_zeros((G, g + 1)), token_idx,
                              torch.ones_like(combine))
    dropped = torch.mean((sel[:, :g] == 0).float())
    z = _z_loss(logits) if moe.z_loss_weight else logits.new_zeros(())
    return Routing(token_idx=token_idx, combine=combine, probs=probs,
                   aux_loss=probs.new_zeros(()), z_loss=z,
                   dropped_frac=dropped)


def _slot_tables(top_e, pos, keep, w, g: int, E: int, cap: int):
    """Scatter the kept (token, k) claims into the (G, E, cap) slot
    tables; overflow goes to the trash slot (E, cap), cut off after."""
    G, _, k = top_e.shape
    dev = top_e.device
    slot_e = torch.where(keep, top_e.long(), torch.full_like(top_e, E).long())
    slot_p = torch.where(keep, pos.long(), torch.full_like(pos, cap).long())
    flat = ((torch.arange(G, device=dev)[:, None, None] * (E + 1) + slot_e)
            * (cap + 1) + slot_p).reshape(-1)
    tok = torch.arange(g, device=dev)[None, :, None].expand(G, g, k)
    n = G * (E + 1) * (cap + 1)
    token_idx = torch.full((n,), g, dtype=torch.int64, device=dev)
    token_idx = token_idx.scatter(0, flat, tok.reshape(-1))
    combine = w.new_zeros((n,)).scatter(0, flat, w.reshape(-1))
    shape = (G, E + 1, cap + 1)
    return (token_idx.reshape(shape)[:, :E, :cap],
            combine.reshape(shape)[:, :E, :cap])


def _positions_of(top_e, E: int):
    """Capacity claims in token-major, k-minor order: for each
    assignment, how many earlier assignments claimed the same expert."""
    G, g, k = top_e.shape
    oh = F.one_hot(top_e.long(), E + 1)[..., :E]  # dead id E -> zeros
    # (G, E, g*k) int32: the scan runs along the innermost axis, where
    # CUDA's scan is fast (along the token axis it took ~9 ms a layer at
    # the training shapes on an H100).
    flat = oh.reshape(G, g * k, E).transpose(1, 2).to(torch.int32)
    pos_flat = torch.cumsum(flat, dim=-1, dtype=torch.int32) - flat
    return (pos_flat * flat).sum(1).reshape(G, g, k)


def route_top_k(
    logits: torch.Tensor,
    moe: MoECfg,
    *,
    k: Optional[int] = None,
    bpr: Optional[bool] = None,
    token_mask: Optional[torch.Tensor] = None,
    slot_tables: bool = True,
) -> Routing:
    """Top-K token-choice routing with capacity and optional Batch
    Prioritized Routing (paper §B.1). ``token_mask`` (G, g) bool: False
    marks dead tokens — their assignments go to the trash id E before
    capacity accounting, so they claim nothing and carry zero weight.
    ``slot_tables`` False leaves ``token_idx``/``combine`` None (the
    sorted dispatch reads the token-major view only)."""
    G, g, E = logits.shape
    k = moe.top_k if k is None else k
    bpr = moe.bpr if bpr is None else bpr
    cap = capacity(g, moe)
    probs = torch.softmax(logits.float(), dim=-1)
    # lax.top_k breaks ties toward the lower expert id (e.g. zero-padded
    # tokens' uniform probs); a stable descending sort does the same.
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :k], top_e[..., :k].to(torch.int32)
    if token_mask is not None:
        top_e = torch.where(token_mask[..., None], top_e,
                            torch.full_like(top_e, E))

    if bpr:
        # Capacity goes to the most confident tokens first: stable sort
        # by -top1 prob (lax.sort is stable), claim, then un-sort.
        order = torch.sort(-top_w[..., 0], dim=1, stable=True).indices
        top_e_sorted = torch.gather(top_e, 1, order[..., None].expand(-1, -1, k))
        pos_s = _positions_of(top_e_sorted, E)
        inv = torch.argsort(order, dim=1)
        pos = torch.gather(pos_s, 1, inv[..., None].expand(-1, -1, k))
    else:
        pos = _positions_of(top_e, E)
    keep = pos < cap
    if token_mask is not None:
        keep = keep & token_mask[..., None]
    w = top_w * keep
    if moe.normalize_combine_weights:
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)

    no_keep = 1.0 - torch.any(keep, dim=-1).float()
    top1 = F.one_hot(top_e[..., 0].long(), E + 1)[..., :E].float()
    if token_mask is None:
        dropped = torch.mean(no_keep)
        density = top1.mean(dim=1)
        p_mean = probs.mean(dim=1)
    else:
        live = token_mask.float()
        n_live = torch.clamp(live.sum(-1, keepdim=True), min=1.0)
        dropped = torch.mean((no_keep * live).sum(-1) / n_live[:, 0])
        density = top1.sum(dim=1) / n_live
        p_mean = (probs * live[..., None]).sum(dim=1) / n_live
    aux = E * torch.mean(torch.sum(density * p_mean, dim=-1))
    z = _z_loss(logits) if moe.z_loss_weight else logits.new_zeros(())
    token_idx = combine = None
    if slot_tables:
        token_idx, combine = _slot_tables(top_e, pos, keep, w, g, E, cap)
    return Routing(
        token_idx=token_idx,
        combine=combine,
        probs=probs,
        aux_loss=aux,
        z_loss=z,
        dropped_frac=dropped,
        token_expert=torch.where(keep, top_e, torch.full_like(top_e, E)),
        token_weight=w,
        token_slot=torch.where(keep, pos.to(torch.int32),
                               torch.full_like(top_e, cap)),
    )


def route(logits, moe: MoECfg, router_kind: str, *,
          token_mask: Optional[torch.Tensor] = None,
          slot_tables: bool = True) -> Routing:
    if router_kind == "expert_choice":
        if token_mask is not None:
            # Decoders, the only place dead decode slots exist, route
            # token-choice (stack_router_kind, paper §3.1).
            raise ValueError(
                "token_mask is only supported by token-choice routers")
        return route_expert_choice(logits, moe)
    kw = dict(token_mask=token_mask, slot_tables=slot_tables)
    if router_kind == "top_k":
        return route_top_k(logits, moe, **kw)
    if router_kind == "switch":
        return route_top_k(logits, moe, k=1, **kw)
    raise ValueError(f"unknown router {router_kind!r}")


# ---------------------------------------------------------------------------
# moving rows between tokens and an assignment stream in a fixed order
# ---------------------------------------------------------------------------


def _expert_major_sum(rows, tok, g: int, experts: int):
    """Expert by expert, in order, one ``index_add_`` of the expert's
    rows into their tokens' rows (row g takes the unfilled slots and is
    cut off). No token appears twice among one expert's rows, so every
    launch adds at most one row into each token's: the order of addition
    is fixed, with no atomic races. rows (G, E * cap, d) -> (G, g, d)."""
    G, N, d = rows.shape
    cap = N // experts
    ids = (torch.arange(G, device=rows.device)[:, None] * (g + 1)
           + torch.clamp(tok.long(), max=g)).reshape(G, experts, cap)
    rows = rows.reshape(G, experts, cap, d)
    y = rows.new_zeros((G * (g + 1), d))
    for e in range(experts):
        y.index_add_(0, ids[:, e].reshape(-1), rows[:, e].reshape(-1, d))
    return y.reshape(G, g + 1, d)[:, :g]


def _take_rows(xg, tok):
    """rows[G, i] = xg[G, tok[G, i]], zero where tok >= g (one row
    gather)."""
    G, g, d = xg.shape
    xp = torch.cat([xg, xg.new_zeros((G, 1, d))], 1).reshape(-1, d)
    idx = (torch.arange(G, device=xg.device)[:, None] * (g + 1)
           + torch.clamp(tok.long(), max=g))
    return xp.index_select(0, idx.reshape(-1)).reshape(G, -1, d)


class _ExpertMajorCombine(torch.autograd.Function):
    """:func:`_expert_major_sum` forward, a gather of each row's token
    gradient backward."""

    @staticmethod
    def forward(ctx, rows, tok, g, experts):
        ctx.save_for_backward(tok)
        return _expert_major_sum(rows, tok, g, experts)

    @staticmethod
    def backward(ctx, dy):
        (tok,) = ctx.saved_tensors
        return _take_rows(dy, tok), None, None, None


class _ExpertMajorTake(torch.autograd.Function):
    """:func:`_take_rows` forward, :func:`_expert_major_sum` backward
    (the transpose of the combine: a token's gradient sums its slots'
    in a fixed order)."""

    @staticmethod
    def forward(ctx, xg, tok, experts):
        ctx.save_for_backward(tok)
        ctx.g, ctx.experts = xg.shape[1], experts
        return _take_rows(xg, tok)

    @staticmethod
    def backward(ctx, drows):
        (tok,) = ctx.saved_tensors
        return _expert_major_sum(drows, tok, ctx.g, ctx.experts), None, None


def combine_stream(rows, tok, g: int, experts: int):
    """Expert Choice's combine: each token's rows of the expert-major
    slot stream (``rows (G, E * cap, d)``, each slot's weighted output;
    ``tok (G, E * cap)`` its group-local token, g or more: none; no
    token twice among one expert's rows) summed in expert order, so a
    call repeats bit for bit on the card (no atomic adds, forward or
    backward), never through a ``(G, g, E, d)`` buffer. Returns (G, g,
    d)."""
    return _ExpertMajorCombine.apply(rows, tok, g, experts)


def take_stream(xg, tok, experts: int):
    """The transpose of :func:`combine_stream`: each slot's token row,
    ``(G, E * cap, d)`` from ``xg (G, g, d)`` (zero where ``tok >=
    g``), whose backward sums each token's gradients in expert order."""
    return _ExpertMajorTake.apply(xg, tok, experts)


class RowMap(NamedTuple):
    """Which rows of a buffer of R rows (the experts' slots, the ragged
    rows, a send buffer) each of T units (tokens; for Expert Choice's
    stream, its entries) owns, each unit at most A rows and each row at
    most one unit. ``src (R,)``: each row's unit, T where none;
    ``table (T, A)``: each unit's rows in a fixed order (slot order), R
    where none. :func:`take_rows` and :func:`sum_rows` are each other's
    transposes."""

    src: torch.Tensor
    table: torch.Tensor


def row_map(table: torch.Tensor, n_rows: int) -> RowMap:
    """The :class:`RowMap` of ``table (T, A)`` (``n_rows`` where none)."""
    T, A = table.shape
    table = table.long()
    unit = torch.arange(T, device=table.device).repeat_interleave(A)
    # Entries of no row all land on the cut-off row n_rows.
    src = torch.full((n_rows + 1,), T, dtype=torch.int64,
                     device=table.device)
    src = src.index_copy(0, table.reshape(-1), unit)[:n_rows]
    return RowMap(src, table)


def _gather_rows(x, src):
    """out[i] = x[src[i]], zero where src[i] == len(x)."""
    xp = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return xp.index_select(0, src)


def _sum_rows(rows, table):
    """y[t] = the sum over a, in order, of rows[table[t, a]] (none where
    table >= R)."""
    T, A = table.shape
    R, d = rows.shape
    got = rows.index_select(0, torch.clamp(table, max=max(R - 1, 0))
                            .reshape(-1)).reshape(T, A, d)
    got.masked_fill_((table >= R)[..., None], 0)
    return got.sum(1)


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, table):
        ctx.save_for_backward(table)
        return _gather_rows(x, src)

    @staticmethod
    def backward(ctx, drows):
        (table,) = ctx.saved_tensors
        return _sum_rows(drows, table), None, None


class _SumRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, src, table):
        ctx.save_for_backward(src)
        return _sum_rows(rows, table)

    @staticmethod
    def backward(ctx, dy):
        (src,) = ctx.saved_tensors
        return _gather_rows(dy, src), None, None


def take_rows(x: torch.Tensor, m: RowMap) -> torch.Tensor:
    """The MoE dispatch: ``(R, d)`` rows, each its unit's row of ``x
    (T, d)`` (zero where a row has none), one row gather; its backward
    sums each unit's row gradients in table order (no atomic adds)."""
    return _TakeRows.apply(x, m.src, m.table)


def sum_rows(rows: torch.Tensor, m: RowMap) -> torch.Tensor:
    """The MoE combine: ``(T, d)``, each unit's rows of ``rows (R, d)``
    summed in table order, so a call repeats bit for bit on the card;
    its backward gives each row its unit's gradient (a row gather)."""
    return _SumRows.apply(rows, m.src, m.table)


def stream_units(xg, tok, experts: Optional[int]):
    """The units an assignment stream's rows are taken from, and the
    count of stream entries each owns: the tokens, ``(G * g, d)``, for a
    token-major stream (``experts`` None, A = N / g); for Expert
    Choice's expert-major stream each entry's own copy of its token's
    row (:func:`take_stream`), A = 1. :func:`units_to_tokens` is the
    way back."""
    G, g, d = xg.shape
    if experts is None:
        return xg.reshape(G * g, d), tok.shape[1] // g
    return take_stream(xg, tok, experts).reshape(-1, d), 1


def units_to_tokens(y_units, tok, g: int, experts: Optional[int]):
    """(G, g, d) from the units' combined rows (:func:`stream_units`)."""
    G, d = tok.shape[0], y_units.shape[-1]
    if experts is None:
        return y_units.reshape(G, g, d)
    return combine_stream(y_units.reshape(G, -1, d), tok, g, experts)


def assignment_stream(r: Routing, num_experts: int, group: int):
    """Flat per-group assignment stream ``(tok, eid, w)``, each
    ``(G, N)``: group-local token id, expert id and combine weight.
    Token-choice routers give it token-major (N = g*k, E = dropped);
    Expert Choice slots are already expert-major and fully dense, so its
    slot table flattens directly (N = E*cap)."""
    if r.token_expert is not None:
        G, g, A = r.token_expert.shape
        tok = torch.arange(group, dtype=torch.int32,
                           device=r.token_expert.device)
        tok = tok[None, :, None].expand(G, group, A).reshape(G, group * A)
        return (tok, r.token_expert.reshape(G, group * A),
                r.token_weight.reshape(G, group * A))
    G, E, cap = r.token_idx.shape
    eid = torch.arange(E, dtype=torch.int32, device=r.token_idx.device)
    eid = eid[None, :, None].expand(G, E, cap).reshape(G, E * cap)
    return (r.token_idx.reshape(G, E * cap).to(torch.int32), eid,
            r.combine.reshape(G, E * cap))
