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


def router_init(gen, d_model: int, moe: MoECfg, *, device=None):
    return {"w": pm.normal(gen, (d_model, moe.num_experts),
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
    Tokens selected by no expert keep weight 0 (residual passthrough)."""
    G = combine.shape[0]
    denom = combine.new_zeros((G, g + 1))
    denom = torch.clamp(_scatter_add_groups(denom, token_idx, combine),
                        min=1e-9)
    per_slot = torch.gather(denom, 1, token_idx.reshape(G, -1))
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
