"""Plain PyTorch versions of the CUDA kernels (port of
``repro/kernels/ref.py`` and of the XLA oracles in
``repro/kernels/ops.py``).

The CPU path runs these; ``chip_smoke.py`` holds each kernel against
them on the card. They compute in float32 and repeat the kernels'
arithmetic without tiling — no yardstick of speed. The backward
versions recompute explicitly, as the kernels do, rather than asking
autograd.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import attention_delta
from repro_torch.kernels.grouped_mlp import ragged_row_offsets
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


def _segments(group_sizes, block: int):
    """(g, e, first row, live rows) of every expert segment holding a
    valid row: its live blocks, ``ceil(size / block) * block`` rows from
    the segment's aligned start (one host read of the sizes)."""
    row_off, _ = ragged_row_offsets(group_sizes, block)
    sizes, starts = group_sizes.tolist(), row_off.tolist()
    for g, row in enumerate(sizes):
        for e, n in enumerate(row):
            if n > 0:
                yield g, e, starts[g][e], -(-n // block) * block


def grouped_mlp_ref(xs, wi, wg, wo, group_sizes, *, block: int,
                    act: str = "silu"):
    """Grouped expert FFN over the block-aligned ragged buffer.

    xs: (G, M, d); group_sizes (G, E). Walks the expert segments: one
    ``act(x@wi) * (x@wg) @ wo`` over each segment's live blocks, in
    float32; dead blocks (tail blocks, an empty expert's block) give
    zeros. Returns (G, M, d) in xs' dtype."""
    y = torch.zeros(xs.shape, dtype=torch.float32, device=xs.device)
    for g, e, s, n in _segments(group_sizes, block):
        x = xs[g, s:s + n].float()
        h = x @ wi[e].float()
        if wg is not None:
            h = activation(act)(h) * (x @ wg[e].float())
        else:
            h = activation(act)(h)
        y[g, s:s + n] = h @ wo[e].float()
    return y.to(xs.dtype)


def _act_grad(act: str, a):
    """d act(a) / d a, explicitly (silu, tanh-gelu, squared relu)."""
    if act == "sqrelu":
        return 2.0 * torch.relu(a)
    if act == "silu":
        s = torch.sigmoid(a)
        return s * (1.0 + a * (1.0 - s))
    if act == "gelu":
        k0, c = math.sqrt(2.0 / math.pi), 0.044715
        t = torch.tanh(k0 * (a + c * a ** 3))
        return 0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * k0 * (
            1.0 + 3.0 * c * a * a)
    raise ValueError(f"expert FFN backward: unsupported act {act!r}")


def grouped_mlp_dx_ref(xs, wi, wg, wo, dy, group_sizes, *, block: int,
                       act: str = "silu"):
    """dx of :func:`grouped_mlp_ref` by explicit recompute per expert
    segment (``_recompute_grads_f_tile`` over whole segments): a = x wi,
    g = x wg, dh = dy wo^T, da = act'(a) dh g, dg = dh act(a),
    dx = da wi^T + dg wg^T (zero on dead blocks). Also returns the
    float32 (G, M, f) da, dg (None when ungated) and h = act(a) g of the
    live blocks (zero elsewhere), the dW kernel's inputs. Returns
    (dx in xs' dtype, da, dg, h)."""
    f32 = torch.float32
    G, M, _ = xs.shape
    f = wi.shape[-1]
    dx = torch.zeros(xs.shape, dtype=f32, device=xs.device)
    da_all = torch.zeros((G, M, f), dtype=f32, device=xs.device)
    dg_all = None if wg is None else torch.zeros_like(da_all)
    h_all = torch.zeros_like(da_all)
    for g, e, s, n in _segments(group_sizes, block):
        x, gy = xs[g, s:s + n].float(), dy[g, s:s + n].float()
        a = x @ wi[e].float()
        dh = gy @ wo[e].float().T
        s_a = activation(act)(a)
        if wg is not None:
            gt = x @ wg[e].float()
            h = s_a * gt
            da = _act_grad(act, a) * dh * gt
            dg = dh * s_a
            dg_all[g, s:s + n] = dg
            dx[g, s:s + n] = da @ wi[e].float().T + dg @ wg[e].float().T
        else:
            h = s_a
            da = _act_grad(act, a) * dh
            dx[g, s:s + n] = da @ wi[e].float().T
        da_all[g, s:s + n] = da
        h_all[g, s:s + n] = h
    return dx.to(xs.dtype), da_all, dg_all, h_all


def grouped_mlp_dw_ref(xs, dy, da, dg, h, group_sizes, *, block: int):
    """float32 dW over each expert segment's valid rows, summed over the
    groups in float32 (group after group): dwi = x^T da, dwg = x^T dg
    (None when dg is), dwo = h^T dy, shapes (E, d, f) / (E, f, d); an
    expert with no rows gets zeros."""
    f32 = torch.float32
    d = xs.shape[-1]
    E, f = group_sizes.shape[1], da.shape[-1]
    dwi = torch.zeros((E, d, f), dtype=f32, device=xs.device)
    dwg = None if dg is None else torch.zeros_like(dwi)
    dwo = torch.zeros((E, f, d), dtype=f32, device=xs.device)
    row_off, _ = ragged_row_offsets(group_sizes, block)
    sizes, starts = group_sizes.tolist(), row_off.tolist()
    for g, row in enumerate(sizes):
        for e, n in enumerate(row):
            if n == 0:
                continue
            s = starts[g][e]
            x = xs[g, s:s + n].float()
            dwi[e] += x.T @ da[g, s:s + n]
            if dg is not None:
                dwg[e] += x.T @ dg[g, s:s + n]
            dwo[e] += h[g, s:s + n].T @ dy[g, s:s + n].float()
    return dwi, dwg, dwo


def grouped_mlp_bwd_ref(xs, wi, wg, wo, dy, group_sizes, *, block: int,
                        act: str = "silu"):
    """Backward of :func:`grouped_mlp_ref`: dx (and da, dg, h) per
    segment, then dW per expert, summed over the groups in float32.
    Returns (dx, dwi, dwg, dwo) in the inputs' dtypes; dwg is None when
    wg is."""
    dx, da, dg, h = grouped_mlp_dx_ref(xs, wi, wg, wo, dy, group_sizes,
                                       block=block, act=act)
    dwi, dwg, dwo = grouped_mlp_dw_ref(xs, dy, da, dg, h, group_sizes,
                                       block=block)
    return (dx, dwi.to(wi.dtype), None if dwg is None else dwg.to(wg.dtype),
            dwo.to(wo.dtype))


def expert_ffn_ref(xe, wi, wg, wo, *, act: str = "silu"):
    """Expert FFN over the padded capacity buffer, in float32: y[..., e]
    = act(x[..., e] @ wi[e]) [* (x[..., e] @ wg[e])] @ wo[e]. xe:
    (..., E, cap, d); wi/wg (E, d, f) (wg may be None), wo (E, f, d).
    Zero rows (unfilled slots) give zero rows. Returns xe's shape and
    dtype."""
    x = xe.float()
    h = torch.einsum("...ecd,edf->...ecf", x, wi.float())
    if wg is not None:
        h = activation(act)(h) * torch.einsum("...ecd,edf->...ecf", x,
                                              wg.float())
    else:
        h = activation(act)(h)
    return torch.einsum("...ecf,efd->...ecd", h, wo.float()).to(xe.dtype)


def expert_ffn_dx_ref(xe, wi, wg, wo, dy, *, act: str = "silu"):
    """dx of :func:`expert_ffn_ref` by explicit recompute (the dx
    kernel's arithmetic): a = x wi, g = x wg, dh = dy wo^T,
    da = act'(a) dh g, dg = dh act(a), dx = da wi^T + dg wg^T. Also
    returns the float32 (..., E, cap, f) da, dg (None when ungated) and
    h = act(a) g, the dW kernel's inputs. Returns (dx in xe's dtype, da,
    dg, h)."""
    x, gy = xe.float(), dy.float()
    a = torch.einsum("...ecd,edf->...ecf", x, wi.float())
    dh = torch.einsum("...ecd,efd->...ecf", gy, wo.float())
    s_a = activation(act)(a)
    if wg is not None:
        gt = torch.einsum("...ecd,edf->...ecf", x, wg.float())
        h, da, dg = s_a * gt, _act_grad(act, a) * dh * gt, dh * s_a
        dx = (torch.einsum("...ecf,edf->...ecd", da, wi.float())
              + torch.einsum("...ecf,edf->...ecd", dg, wg.float()))
    else:
        h, da, dg = s_a, _act_grad(act, a) * dh, None
        dx = torch.einsum("...ecf,edf->...ecd", da, wi.float())
    return dx.to(xe.dtype), da, dg, h


def expert_ffn_dw_ref(xe, dy, da, dg, h):
    """float32 dW over every row of each expert, summed over the leading
    group axes and the capacity: dwi = x^T da, dwg = x^T dg (None when dg
    is), dwo = h^T dy; shapes (E, d, f) / (E, f, d)."""
    x, gy = xe.float(), dy.float()
    dwi = torch.einsum("...ecd,...ecf->edf", x, da)
    dwg = None if dg is None else torch.einsum("...ecd,...ecf->edf", x, dg)
    dwo = torch.einsum("...ecf,...ecd->efd", h, gy)
    return dwi, dwg, dwo


def expert_ffn_bwd_ref(xe, wi, wg, wo, dy, *, act: str = "silu"):
    """Backward of :func:`expert_ffn_ref`: dx (and da, dg, h), then dW
    in float32, cast to the weights' dtype. Returns (dx, dwi, dwg, dwo);
    dwg is None when wg is."""
    dx, da, dg, h = expert_ffn_dx_ref(xe, wi, wg, wo, dy, act=act)
    dwi, dwg, dwo = expert_ffn_dw_ref(xe, dy, da, dg, h)
    return (dx, dwi.to(wi.dtype),
            None if dwg is None else dwg.to(wg.dtype), dwo.to(wo.dtype))


def _attention_mask(Sq, Skv, causal, q_offset, kv_len, device):
    """(Sq, Skv) valid-key mask: key t < kv_len and, when causal,
    t <= q_offset + i for query row i."""
    kv_pos = torch.arange(Skv, device=device)
    mask = (kv_pos < kv_len)[None, :].expand(Sq, Skv)
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=device)
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    return mask


def _scores(q, k):
    """GQA scores (B, Kh, G, Sq, Skv) in float32, scaled."""
    B, Sq, H, dh = q.shape
    Kh = k.shape[2]
    qg = q.float().reshape(B, Sq, Kh, H // Kh, dh)
    return torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) * dh ** -0.5


def flash_attention_ref(q, k, v, *, causal=True, q_offset=0, kv_len=None):
    """Dense GQA attention with the flash kernel's outputs: q (B, Sq, H,
    dh), k/v (B, Skv, Kh, dh); query row i sits at q_offset + i.
    Returns (o (B, Sq, H, dh) in q's dtype, lse (B, H, Sq) float32).
    A row with no valid key gives o = 0 and lse = +inf."""
    B, Sq, H, dh = q.shape
    Skv = k.shape[1]
    kv_len = Skv if kv_len is None else kv_len
    mask = _attention_mask(Sq, Skv, causal, q_offset, kv_len, q.device)
    s = _scores(q, k).masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(mask, torch.exp(s - m_safe), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    lse = torch.where(l > 0, m_safe + torch.log(l),
                      torch.full_like(l, float("inf")))[..., 0]
    p = p / torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    return (o.reshape(B, Sq, H, dh).to(q.dtype).contiguous(),
            lse.reshape(B, H, Sq).contiguous())


def _p_ds(q, k, v, do, lse, delta, causal, q_offset, kv_len):
    """Recompute p = exp(s - lse) on valid keys and ds = p (dO v^T -
    delta), (B, Kh, G, Sq, Skv) float32 (``_recompute_p_ds``)."""
    B, Sq, H, dh = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    kv_len = Skv if kv_len is None else kv_len
    mask = _attention_mask(Sq, Skv, causal, q_offset, kv_len, q.device)
    lse_g = lse.reshape(B, Kh, G, Sq)[..., None]
    p = torch.where(mask, torch.exp(_scores(q, k) - lse_g),
                    torch.zeros((), device=q.device))
    dog = do.float().reshape(B, Sq, Kh, G, dh)
    dp = torch.einsum("bqkgd,btkd->bkgqt", dog, v.float())
    ds = p * (dp - delta.reshape(B, Kh, G, Sq)[..., None])
    return p, ds


def flash_attention_dq_ref(q, k, v, do, lse, delta, *, causal=True,
                           q_offset=0, kv_len=None):
    """dq = ds k * scale, given lse and delta = rowsum(dO * O) (B, H,
    Sq). Returns (B, Sq, H, dh) in q's dtype."""
    B, Sq, H, dh = q.shape
    Kh = k.shape[2]
    _, ds = _p_ds(q, k, v, do, lse, delta, causal, q_offset, kv_len)
    dq = torch.einsum("bkgqt,btkd->bqkgd", ds, k.float()) * dh ** -0.5
    return dq.reshape(B, Sq, H, dh).to(q.dtype).contiguous()


def flash_attention_dkv_ref(q, k, v, do, lse, delta, *, causal=True,
                            q_offset=0, kv_len=None):
    """dk = ds^T q * scale and dv = p^T dO, each summed over its kv
    head's query heads. Returns (dk, dv) in k's and v's dtypes."""
    B, Sq, H, dh = q.shape
    Kh = k.shape[2]
    G = H // Kh
    p, ds = _p_ds(q, k, v, do, lse, delta, causal, q_offset, kv_len)
    qg = q.float().reshape(B, Sq, Kh, G, dh)
    dog = do.float().reshape(B, Sq, Kh, G, dh)
    dk = torch.einsum("bkgqt,bqkgd->btkd", ds, qg) * dh ** -0.5
    dv = torch.einsum("bkgqt,bqkgd->btkd", p, dog)
    return dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous()


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True,
                            q_offset=0, kv_len=None):
    """Backward of :func:`flash_attention_ref` by explicit recompute
    (``_recompute_p_ds``): delta = rowsum(dO * O), then dq and (dk, dv).
    Returns (dq, dk, dv) in the inputs' dtypes."""
    delta = attention_delta(o, do)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    dq = flash_attention_dq_ref(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_attention_dkv_ref(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


def rwkv6_chunked_ref(r, k, v, w, u, *, initial_state=None, chunk=64):
    """Chunked-parallel WKV-6 (port of the reference's XLA path,
    ``ops._rwkv6_chunked_xla``): within a chunk of c steps, with the
    cumulative decay A_t = prod_{s<=t} w_s taken in log space (w clipped
    to [1e-12, 1]),

        o_t  = r_t A_{t-1} . S_in + sum_{s<t} (r_t A_{t-1} / A_s) . k_s v_s
               + r_t . (u k_t) v_t
        S_out = A_c S_in + sum_s (A_c / A_s) k_s v_s

    r, k, w: (B, T, H, K); v: (B, T, H, V); u: (H, K); initial_state
    (B, H, K, V) float32 or None (zeros). The tail is padded with w = 1.
    Returns (o (B, T, H, V) in v's dtype, final state float32)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    f32, out_dtype = torch.float32, v.dtype
    c = min(chunk, T)
    pad = (-T) % c
    r, k, v, w = (t.to(f32) for t in (r, k, v, w))
    if pad:
        zpad = lambda t, val=0.0: torch.nn.functional.pad(  # noqa: E731
            t, (0, 0, 0, 0, 0, pad), value=val)
        r, k, v, w = zpad(r), zpad(k), zpad(v), zpad(w, 1.0)
    n = (T + pad) // c
    S = (torch.zeros(B, H, K, V, dtype=f32, device=r.device)
         if initial_state is None else initial_state.to(f32))
    u32 = u.to(f32)
    logw = torch.log(torch.clamp(w, 1e-12, 1.0)).reshape(B, n, c, H, K)
    logA = torch.cumsum(logw, dim=2)  # inclusive
    rs, ks = r.reshape(B, n, c, H, K), k.reshape(B, n, c, H, K)
    vs = v.reshape(B, n, c, H, V)
    mask = (torch.arange(c, device=r.device)[:, None]
            > torch.arange(c, device=r.device)[None, :])
    outs = []
    for i in range(n):
        rc, kc, vc, la, lw = rs[:, i], ks[:, i], vs[:, i], logA[:, i], \
            logw[:, i]
        la_prev = la - lw  # A_{t-1}
        o = torch.einsum("bchk,bhkv->bchv", rc * torch.exp(la_prev), S)
        ratio = la_prev[:, :, None] - la[:, None, :]  # (B, t, s, H, K)
        decay = torch.exp(ratio.masked_fill(
            ~mask[None, :, :, None, None], float("-inf")))
        att = torch.einsum("bthk,btshk,bshk->btsh", rc, decay, kc)
        o = o + torch.einsum("btsh,bshv->bthv", att, vc)
        o = o + torch.einsum("bthk,hk,bthk,bthv->bthv", rc, u32, kc, vc)
        outs.append(o)
        la_end = la[:, -1][:, None]  # (B, 1, H, K)
        carry = torch.exp(la_end - la)
        S = torch.exp(la_end[:, 0])[..., None] * S + torch.einsum(
            "bshk,bshv->bhkv", kc * carry, vc)
    return torch.cat(outs, dim=1)[:, :T].to(out_dtype), S


def rwkv6_ref(r, k, v, w, u, *, initial_state=None):
    """WKV-6 oracle, the sequential recurrence (port of the reference's
    ``rwkv6_ref``), in float32:

        o_t = r_t . (S + u * k_t v_t^T);   S <- diag(w_t) S + k_t v_t^T

    Shapes as :func:`rwkv6_chunked_ref`; w is used as given (no clip).
    Returns (o (B, T, H, V) in v's dtype, final state float32)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    f32 = torch.float32
    out_dtype = v.dtype
    r, k, v, w = (t.to(f32) for t in (r, k, v, w))
    u = u.to(f32)
    S = (torch.zeros(B, H, K, V, dtype=f32, device=r.device)
         if initial_state is None else initial_state.to(f32))
    outs = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B, H, K, V)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 S + u[None, :, :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    o = (torch.stack(outs, dim=1) if outs
         else torch.zeros(B, 0, H, V, dtype=f32, device=r.device))
    return o.to(out_dtype), S
