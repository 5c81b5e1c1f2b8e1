"""The MoE layer: router + sorted ragged dispatch + grouped expert FFN +
scatter-add combine (port of ``repro/core/moe.py``, ``dispatch="sorted"``).

The flat assignment stream is stable-sorted by expert into a
block-aligned ragged buffer ``(G, M, d)`` (M independent of the
capacity factor) that goes through ``kernels.ops.grouped_mlp``. The
padded einsum/gather dispatches and expert parallelism are queued in
ROADMAP.md; asking for them raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import ArchConfig, MoECfg
from repro_torch.core import routing as R
from repro_torch.kernels import ops
from repro_torch.kernels.grouped_mlp import ROW_BLOCK, ragged_destinations
from repro_torch.models import param as pm


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


def _sorted_dispatch(params, xg, r: R.Routing, cfg: ArchConfig,
                     moe: MoECfg, *, implementation: str):
    """Sort the flat assignment stream by expert into a ragged buffer
    aligned to the grouped kernel's row block (:data:`ROW_BLOCK`; results
    do not depend on it), run it through the grouped FFN, unsort through
    a scatter-add combine (one row per surviving assignment, accumulated
    per token). Returns y (G, g, d)."""
    G, g, d = xg.shape
    E = moe.num_experts
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
    dispatch: str = "sorted",
    implementation: str = "auto",
    token_mask=None,
):
    """x: (B, S, d) or (N, d). Returns (y, metrics dict).

    ``token_mask``: None, or a bool tensor broadcastable to x's token
    dims — False marks dead tokens (free decode slots, idle chunk
    lanes): they claim no experts, no capacity and no ragged rows, and
    their outputs are zero."""
    if dispatch != "sorted":
        raise NotImplementedError(
            f"dispatch={dispatch!r} is not ported yet; the port runs "
            "dispatch='sorted' (einsum/gather are queued in ROADMAP.md)"
        )
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
    r = R.route(logits, moe, router_kind, token_mask=mg)
    y = _sorted_dispatch(params, xg, r, cfg, moe,
                         implementation=implementation)
    y = y.reshape(-1, d)
    if pad:
        y = y[:n]
    y = y.reshape(orig_shape).to(x.dtype)
    metrics = {
        "aux_loss": r.aux_loss * moe.aux_loss_weight,
        "z_loss": r.z_loss * moe.z_loss_weight,
        "dropped_frac": r.dropped_frac,
        "router_prob_mean_max": r.probs.max(-1).values.mean(),
    }
    return y, metrics
