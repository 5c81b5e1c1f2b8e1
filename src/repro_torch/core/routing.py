"""Token-choice routers: Top-K (with BPR) and Switch (port of
``repro/core/routing.py``).

Routing works on token groups ``(G, g, d)`` with logits ``(G, g, E)``.
The port exposes the token-major assignment view the sorted dispatch
consumes (``token_expert`` / ``token_weight``); the padded ``(G, E,
cap)`` slot tables feed only the einsum/gather dispatches, which are
queued in ROADMAP.md, as is Expert Choice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs import MoECfg
from repro_torch.models import param as pm


class Routing(NamedTuple):
    probs: torch.Tensor  # (G, g, E) f32 router probabilities
    aux_loss: torch.Tensor  # scalar
    z_loss: torch.Tensor  # scalar
    dropped_frac: torch.Tensor  # scalar
    # (G, g, k) int32 expert id per assignment; E marks a dropped or dead
    # assignment. Claims and drops are exactly the reference's.
    token_expert: torch.Tensor
    token_weight: torch.Tensor  # (G, g, k) f32, 0 where dropped


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
) -> Routing:
    """Top-K token-choice routing with capacity and optional Batch
    Prioritized Routing (paper §B.1). ``token_mask`` (G, g) bool: False
    marks dead tokens — their assignments go to the trash id E before
    capacity accounting, so they claim nothing and carry zero weight."""
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
    return Routing(
        probs=probs,
        aux_loss=aux,
        z_loss=z,
        dropped_frac=dropped,
        token_expert=torch.where(keep, top_e, torch.full_like(top_e, E)),
        token_weight=w,
    )


def route(logits, moe: MoECfg, router_kind: str, *,
          token_mask: Optional[torch.Tensor] = None) -> Routing:
    if router_kind == "expert_choice":
        raise NotImplementedError(
            "Expert Choice routing is not ported yet (ROADMAP.md, other "
            "families: encoder stacks are its only users)"
        )
    if router_kind == "top_k":
        return route_top_k(logits, moe, token_mask=token_mask)
    if router_kind == "switch":
        return route_top_k(logits, moe, k=1, token_mask=token_mask)
    raise ValueError(f"unknown router {router_kind!r}")


def assignment_stream(r: Routing, num_experts: int, group: int):
    """Flat per-group assignment stream ``(tok, eid, w)``, each
    ``(G, N)`` with N = g*k, token-major: group-local token id, expert id
    (E = dropped) and combine weight."""
    G, g, A = r.token_expert.shape
    tok = torch.arange(group, dtype=torch.int32,
                       device=r.token_expert.device)
    tok = tok[None, :, None].expand(G, group, A).reshape(G, group * A)
    return (tok, r.token_expert.reshape(G, group * A),
            r.token_weight.reshape(G, group * A))
