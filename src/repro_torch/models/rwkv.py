"""RWKV-6 "Finch" blocks (arXiv:2404.05892): time-mix with data-dependent
decay, and the channel-mix wrapper (port of ``repro/models/rwkv.py``).

The decay LoRA (w = exp(-exp(w0 + tanh(x A) B)), in float32) and the
per-head bonus ``u`` follow the paper; the token shift is the
reference's per-stream mu-lerp. The WKV recurrence runs through
``kernels.ops.rwkv6`` (the CUDA kernel, or the plain chunked version).

The channel-mix exposes its 2-matrix sqrelu MLP through the stack's FFN
slot, so sparse upcycling applies to it; its token shift and receptance
gate stay per layer (``channel_mix_pre``).

Caches (the static serve engine): the time-mix keeps the last token's
input ``x_prev (B, d)`` and the WKV state ``wkv (B, H, K, K)`` (V = K),
the channel-mix its own ``x_prev``. The reference returns new cache
arrays (its engine donates the old ones); here the cache tensors are
overwritten in place, after the step has read them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.models import param as pm

LORA_DIM = 64


def _hk(cfg: ArchConfig):
    K = cfg.ssm.head_size
    return cfg.d_model // K, K


def time_mix_init(gen, cfg: ArchConfig, *, dtype=torch.float32,
                  device=None):
    d = cfg.d_model
    H, K = _hk(cfg)
    kw = dict(dtype=dtype, device=device)
    # Decay base: spread so exp(-exp(w0)) covers slow..fast per channel.
    w0 = -5.0 + 8.0 * (torch.arange(d, dtype=torch.float32, device=device)
                       / max(d - 1, 1)) ** 0.7
    return {
        "mu": pm.full((5, d), 0.5, "_ embed", **kw),  # lerp for w, k, v, r, g
        "w0": pm.tag(w0.to(dtype), "embed"),
        "w_lora_a": pm.normal(gen, (d, LORA_DIM), "embed _", std=0.02,
                              **kw),
        "w_lora_b": pm.zeros((LORA_DIM, d), "_ embed", **kw),
        "wr": pm.dense(gen, (d, H, K), "embed heads head_dim", **kw),
        "wk": pm.dense(gen, (d, H, K), "embed heads head_dim", **kw),
        "wv": pm.dense(gen, (d, H, K), "embed heads head_dim", **kw),
        "wg": pm.dense(gen, (d, H, K), "embed heads head_dim", **kw),
        "u": pm.normal(gen, (H, K), "heads head_dim", std=0.02, **kw),
        "wo": pm.dense(gen, (H, K, d), "heads head_dim embed",
                       fan_in=H * K, **kw),
        "ln_x": {"scale": pm.ones((d,), "embed", **kw),
                 "bias": pm.zeros((d,), "embed", **kw)},
    }


TIME_MIX_CACHE_AXES = {
    "x_prev": "batch embed",
    "wkv": "batch heads head_dim head_dim",
}
CHANNEL_MIX_CACHE_AXES = {"x_prev": "batch embed"}


def time_mix_cache_init(cfg: ArchConfig, batch: int, *,
                        dtype=torch.float32, device=None):
    H, K = _hk(cfg)
    return {
        "x_prev": torch.zeros((batch, cfg.d_model), dtype=dtype,
                              device=device),
        "wkv": torch.zeros((batch, H, K, K), dtype=torch.float32,
                           device=device),
    }


def _shift(x, x_prev):
    """x: (B, T, d); x_prev: (B, d) state or None -> the previous-token
    stream (zeros before the first token without a state)."""
    pad = torch.zeros_like(x[:, :1]) if x_prev is None else \
        x_prev[:, None].to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def _group_norm(x, scale, bias, H):
    """Per-head group norm on (B, T, d), eps 1e-5, in float32."""
    B, T, d = x.shape
    xh = x.reshape(B, T, H, d // H).float()
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, unbiased=False)
    xh = (xh - mu) * torch.rsqrt(var + 1e-5)
    return (xh.reshape(B, T, d) * scale + bias).to(x.dtype)


def _heads(x, w):
    """einsum("btd,dhk->bthk") as one matmul."""
    B, T, d = x.shape
    return (x.reshape(B * T, d) @ w.reshape(d, -1)).reshape(
        B, T, *w.shape[1:])


def time_mix_apply(p, x, cfg: ArchConfig, *, cache=None,
                   implementation="auto", ctx=None):
    """x: (B, T, d) -> (y, cache). With a cache (the reference's modes
    "prefill" and "decode", which run alike) the step starts from its
    ``x_prev`` and ``wkv`` state and leaves the new ones in it, in place;
    without one (its "train" mode) it starts from zeros and returns
    None.

    Tensor parallel over heads (a serving ctx, ``sharding.serve_layout``,
    whose weights hold the rank's ``H / m`` heads; read off ``wr``'s
    shape): x is whole on every ``model`` peer; the token shift and the
    decay ``w0 + lora(x)`` run at full d and are cut to the rank's
    heads' columns; ``wr``, ``wk``, ``wv``, ``wg`` and ``u`` are its
    head blocks, the WKV state its heads, ``ln_x`` a group norm on its
    heads with its block of the scale and bias; ``wo`` is row parallel
    (``comm.reduce_from_model``)."""
    from repro_torch.kernels import ops

    H, K = _hk(cfg)
    B, T, d = x.shape
    Hl = p["wr"].shape[1]
    c0 = ctx.tp_rank * Hl * K if Hl != H else 0
    cols = slice(c0, c0 + Hl * K)
    xs = _shift(x, None if cache is None else cache["x_prev"])
    xx = xs - x
    xw, xk, xv, xr, xg = (x + xx * p["mu"][i] for i in range(5))
    w_raw = p["w0"] + torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    w = torch.exp(-torch.exp(w_raw[..., cols].float())).reshape(
        B, T, Hl, K)
    r = _heads(xr, p["wr"])
    k = _heads(xk, p["wk"])
    v = _heads(xv, p["wv"])
    g = F.silu(_heads(xg, p["wg"]))
    o, state = ops.rwkv6(
        r, k, v, w, p["u"],
        initial_state=None if cache is None else cache["wkv"],
        implementation=implementation,
    )
    o = _group_norm(o.reshape(B, T, Hl * K), p["ln_x"]["scale"][cols],
                    p["ln_x"]["bias"][cols], Hl)
    o = o.reshape(B, T, Hl, K) * g
    y = (o.reshape(B * T, Hl * K) @ p["wo"].reshape(Hl * K, d)).reshape(
        B, T, d)
    if Hl != H:
        from repro_torch.sharding import comm

        y = comm.reduce_from_model(y, ctx)
    if cache is None:
        return y, None
    cache["x_prev"].copy_(x[:, -1])
    cache["wkv"].copy_(state)
    return y, cache


# ---------------------------------------------------------------------------
# Channel-mix wrapper: token shift + receptance around the (upcyclable) MLP
# ---------------------------------------------------------------------------


def channel_mix_init(gen, cfg: ArchConfig, *, dtype=torch.float32,
                     device=None):
    d = cfg.d_model
    kw = dict(dtype=dtype, device=device)
    return {
        "mu_k": pm.full((d,), 0.5, "embed", **kw),
        "mu_r": pm.full((d,), 0.5, "embed", **kw),
        "wr": pm.dense(gen, (d, d), "embed embed", **kw),
    }


def channel_mix_cache_init(cfg: ArchConfig, batch: int, *,
                           dtype=torch.float32, device=None):
    return {"x_prev": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                  device=device)}


def channel_mix_pre(p, x, *, cache=None):
    """Returns (MLP input xk, receptance gate r, cache); a cache's
    ``x_prev`` is read, then overwritten in place with x's last token."""
    xs = _shift(x, None if cache is None else cache["x_prev"])
    xx = xs - x
    xk = x + xx * p["mu_k"]
    xr = x + xx * p["mu_r"]
    r = torch.sigmoid(xr @ p["wr"])
    if cache is not None:
        cache["x_prev"].copy_(x[:, -1])
    return xk, r, cache
