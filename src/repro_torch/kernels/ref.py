"""Plain PyTorch versions of the three CUDA kernels (port of
``repro/kernels/ref.py`` and of the XLA oracles in
``repro/kernels/ops.py``).

The CPU path runs these; ``chip_smoke.py`` holds each kernel against
them on the card. They compute in float32 and repeat the kernels'
arithmetic without tiling — no yardstick of speed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.grouped_mlp import block_tables
from repro_torch.models.layers import activation


def _masked_softmax_av(s, mask, v):
    """Zero-valid-key-safe softmax of scores ``s`` under ``mask``, times
    ``v``: rows with no valid key give exact zeros."""
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(mask, torch.exp(s - m_safe), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    return p / torch.where(l == 0.0, torch.ones_like(l), l)


def _gather_pool(pool, tables):
    n, nb = tables.shape
    _, bs, Kh, dh = pool.shape
    return pool[tables.long()].reshape(n, nb * bs, Kh, dh).float()


def decode_attention_ref(q, k_pool, v_pool, block_tables, lengths):
    """q: (B, H, dh); pools (P, bs, Kh, dh); block_tables (B, nb);
    lengths (B,). Gathers each slot's blocks into a dense view and runs
    the masked softmax. Returns (B, H, dh) in q's dtype."""
    B, H, dh = q.shape
    Kh = k_pool.shape[2]
    k = _gather_pool(k_pool, block_tables)
    v = _gather_pool(v_pool, block_tables)
    qg = q.float().reshape(B, Kh, H // Kh, dh)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k) * dh ** -0.5
    T = k.shape[1]
    mask = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    p = _masked_softmax_av(s, mask[:, None, None, :], v)
    y = torch.einsum("bkgt,btkd->bkgd", p, v)
    return y.reshape(B, H, dh).to(q.dtype)


def prefill_attention_ref(q, k_pool, v_pool, block_tables, starts, lens):
    """q: (NC, C, H, dh); row i of chunk c attends pool positions
    ``<= starts[c] + i``; rows ``i >= lens[c]`` give zeros. Returns
    (NC, C, H, dh) in q's dtype."""
    NC, C, H, dh = q.shape
    Kh = k_pool.shape[2]
    k = _gather_pool(k_pool, block_tables)
    v = _gather_pool(v_pool, block_tables)
    qg = q.float().reshape(NC, C, Kh, H // Kh, dh)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k) * dh ** -0.5
    rows = torch.arange(C, device=q.device)
    q_pos = starts[:, None] + rows[None, :]
    valid_q = rows[None, :] < lens[:, None]
    kv_pos = torch.arange(k.shape[1], device=q.device)
    mask = valid_q[:, :, None] & (kv_pos[None, None, :] <= q_pos[:, :, None])
    p = _masked_softmax_av(s, mask[:, None, None], v)
    y = torch.einsum("bkgqt,btkd->bqkgd", p, v)
    return y.reshape(NC, C, H, dh).to(q.dtype)


def grouped_mlp_ref(xs, wi, wg, wo, group_sizes, *, block: int,
                    act: str = "silu"):
    """Grouped expert FFN over the block-aligned ragged buffer.

    xs: (G, M, d); group_sizes (G, E). Each row block gathers its owning
    expert's weights and runs ``act(x@wi) * (x@wg) @ wo`` in float32;
    dead blocks (no valid row) give zeros. Returns (G, M, d) in xs'
    dtype."""
    G, M, d = xs.shape
    nb = M // block
    be, bl = block_tables(group_sizes, block, nb)
    e = be.reshape(-1).long()
    x = xs.float().reshape(G * nb, block, d)
    h = torch.bmm(x, wi.float()[e])
    if wg is not None:
        h = activation(act)(h) * torch.bmm(x, wg.float()[e])
    else:
        h = activation(act)(h)
    y = torch.bmm(h, wo.float()[e])
    y = y * bl.reshape(G * nb, 1, 1).float()
    return y.reshape(G, M, d).to(xs.dtype)
