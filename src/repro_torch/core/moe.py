"""The MoE layer: router + dispatch + expert FFN + combine (port of
``repro/core/moe.py``). Three dispatches, as in the reference:

* ``"gather"`` (the default) — the padded capacity buffer ``xe (G, E,
  cap, d)`` gathered from the routers' slot tables, through
  ``kernels.ops.expert_ffn`` (the expert-FFN kernels on the card), and
  an ``index_add`` combine into ``(G, g + 1, d)`` (row g takes the
  unfilled slots);
* ``"einsum"`` — the same buffer and FFN through one-hot dispatch and
  combine einsums (the GShard-era path);
* ``"sorted"`` — the flat assignment stream stable-sorted by expert
  into a block-aligned ragged buffer ``(G, M, d)`` (M independent of
  the capacity factor) through ``kernels.ops.grouped_mlp``.

The combined output can be tagged with the identity op
``repro_torch::moe_block`` (:func:`moe_block`), the remat boundary that
``stack_apply(remat="moe")``'s policy saves and nothing else (the
reference's ``checkpoint_name(y, "moe_block")``).

Expert parallelism needs a device mesh and is queued in ROADMAP.md.
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
        "wi": pm.dense(gen, (E, d, f), **kw),
        "wo": pm.dense(gen, (E, f, d), fan_in=f, **kw),
    }
    if cfg.gated_mlp:
        experts["wg"] = pm.dense(gen, (E, d, f), **kw)
    # The router stays float32, as in the reference.
    return {"router": R.router_init(gen, d, moe, device=device),
            "experts": experts}


def expert_ffn(experts, xe, cfg: ArchConfig, *, implementation="auto"):
    """xe: (G, E, cap, d) -> (G, E, cap, d) through ``ops.expert_ffn``."""
    return ops.expert_ffn(xe, experts["wi"], experts.get("wg"),
                          experts["wo"], act=cfg.act,
                          implementation=implementation)


def _gather_dispatch(params, xg, r: R.Routing, cfg: ArchConfig, *,
                     implementation: str):
    """Padded gather dispatch: xe[g, e, c] = xg[g, token_idx[g, e, c]]
    (unfilled slots zeroed), the expert FFN, then the weighted rows
    added back per token with ``index_add`` (unfilled slots land in the
    trash row g). On the card the adds run in no fixed order: f32 sums
    of a token's slots may differ in the last bits from run to run.
    Returns y (G, g, d)."""
    G, g, d = xg.shape
    idx = r.token_idx  # (G, E, cap)
    safe = torch.clamp(idx, max=g - 1).reshape(G, -1, 1).expand(-1, -1, d)
    valid = (idx < g)[..., None].to(xg.dtype)
    xe = torch.gather(xg, 1, safe).reshape(*idx.shape, d) * valid
    ye = expert_ffn(params["experts"], xe, cfg,
                    implementation=implementation)
    w = (r.combine[..., None] * valid).to(ye.dtype)
    yw = (ye * w).to(xg.dtype).reshape(-1, d)
    rows = (torch.arange(G, device=xg.device)[:, None] * (g + 1)
            + idx.reshape(G, -1)).reshape(-1)
    y = xg.new_zeros((G * (g + 1), d)).index_add(0, rows, yw)
    return y.reshape(G, g + 1, d)[:, :g]


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
                     implementation: str):
    """Sort the flat assignment stream by expert into a ragged buffer
    aligned to the ragged layout's block (:data:`ROW_BLOCK`; results do
    not depend on it), run it through the grouped FFN, unsort through
    a scatter-add combine (one row per surviving assignment, accumulated
    per token). Returns y (G, g, d)."""
    G, g, d = xg.shape
    E = r.probs.shape[-1]
    tok, eid, w = R.assignment_stream(r, E, g)
    N = tok.shape[1]
    valid = (eid < E) & (tok < g)
    key = torch.where(valid, eid, torch.full_like(eid, E)).to(torch.int32)
    perm, key_s, counts, dest, M = ragged_destinations(key, E, ROW_BLOCK)
    tok_s = torch.gather(tok, 1, perm)
    w_s = torch.gather(w, 1, perm)
    valid_s = key_s < E
    dest = dest.long()
    # src: ragged row -> group-local token (g = pad row); wr: combine
    # weight (0 on pad rows). Row M is the trash row for dropped
    # assignments.
    src = torch.full((G, M + 1), g, dtype=torch.int64, device=xg.device)
    src = src.scatter(1, dest, tok_s.long())[:, :M]
    wr = torch.zeros((G, M + 1), dtype=w.dtype, device=xg.device)
    wr = wr.scatter(1, dest, torch.where(valid_s, w_s,
                                         torch.zeros_like(w_s)))[:, :M]
    pad_row = src >= g
    xs = torch.gather(xg, 1, torch.clamp(src, max=g - 1)[..., None]
                      .expand(G, M, d))
    xs = xs * (1.0 - pad_row[..., None].to(xg.dtype))
    ex = params["experts"]
    ys = ops.grouped_mlp(
        xs, ex["wi"], ex.get("wg"), ex["wo"], counts,
        act=cfg.act, block=ROW_BLOCK, implementation=implementation,
    )
    yw = (ys * wr[..., None]).to(xg.dtype)
    y = torch.zeros((G, g + 1, d), dtype=xg.dtype, device=xg.device)
    y = y.scatter_add(1, src[..., None].expand(G, M, d), yw)
    return y[:, :g]


def _group(x2d, group_size: int):
    n, d = x2d.shape
    g = min(group_size, n)
    pad = (-n) % g
    if pad:
        x2d = torch.cat([x2d, x2d.new_zeros(pad, d)])
    return x2d.reshape(-1, g, d), n, pad


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
    ``remat="moe"`` saves (off by default: the tag copies y)."""
    dispatches = {"gather": _gather_dispatch, "einsum": _einsum_dispatch,
                  "sorted": _sorted_dispatch}
    if dispatch not in dispatches:
        raise ValueError(f"unknown dispatch {dispatch!r} "
                         f"{tuple(dispatches)}")
    router_kind = router_kind or moe.router
    orig_shape = x.shape
    x2d = x.reshape(-1, x.shape[-1])
    xg, n, pad = _group(x2d, moe.group_size)
    G, g, d = xg.shape
    mg = None
    if token_mask is not None:
        m1 = torch.broadcast_to(token_mask, orig_shape[:-1]).reshape(-1)
        m1 = m1.to(torch.bool)
        if pad:
            m1 = torch.cat([m1, m1.new_zeros(pad)])
        mg = m1.reshape(G, g)
    logits = xg.float() @ params["router"]["w"].float()
    r = R.route(logits, moe, router_kind, token_mask=mg,
                slot_tables=dispatch != "sorted")
    y = dispatches[dispatch](params, xg, r, cfg,
                             implementation=implementation)
    y = y.reshape(-1, d)
    if pad:
        y = y[:n]
    y = y.reshape(orig_shape).to(x.dtype)
    if tag:
        y = moe_block(y)
    metrics = {
        "aux_loss": r.aux_loss * moe.aux_loss_weight,
        "z_loss": r.z_loss * moe.z_loss_weight,
        "dropped_frac": r.dropped_frac,
        "router_prob_mean_max": r.probs.max(-1).values.mean(),
    }
    return y, metrics
