"""Core NN layers: activations, norms, MLP, embeddings, RoPE and the
patch frontend (port of
``repro/models/layers.py``). Plain functions on tensors; parameter
trees keep the JAX layouts (``wi (d, f)``, ``wo (f, d)``, embedding
``tokens (V, d)``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.models import param as pm


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation.
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    if name == "sqrelu":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name}")


def norm_init(cfg: ArchConfig, *, device=None):
    d = cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": pm.ones((d,), device=device)}
    return {"scale": pm.ones((d,), device=device),
            "bias": pm.zeros((d,), device=device)}


def norm_apply(p, x, cfg: ArchConfig, *, eps: float = 1e-6):
    """RMSNorm / LayerNorm with f32 math, result in x's dtype."""
    dtype = x.dtype
    x32 = x.float()
    if cfg.norm == "rmsnorm":
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps) * p["scale"].float()
    else:
        mu = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(dtype)


def mlp_init(gen, cfg: ArchConfig, *, dtype=torch.float32, device=None):
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    p = {"wi": pm.dense(gen, (d, f), **kw)}
    if cfg.gated_mlp:
        p["wg"] = pm.dense(gen, (d, f), **kw)
    p["wo"] = pm.dense(gen, (f, d), **kw)
    return p


def mlp_apply(p, x, cfg: ArchConfig):
    """x: (..., d) -> (..., d)."""
    act = activation(cfg.act)
    h = x @ p["wi"]
    if cfg.gated_mlp:
        h = act(h) * (x @ p["wg"])
    else:
        h = act(h)
    return h @ p["wo"]


def embed_init(gen, cfg: ArchConfig, *, dtype=torch.float32, device=None):
    p = {"tokens": pm.normal(gen, (cfg.vocab_size, cfg.d_model),
                             dtype=dtype, device=device)}
    if cfg.pos_emb == "learned":
        p["pos"] = pm.normal(
            gen, (max(cfg.n_frontend_positions, 1) + 8, cfg.d_model),
            dtype=dtype, device=device,
        )
    return p


def embed_apply(p, tokens, cfg: ArchConfig, *, positions=None):
    x = p["tokens"][tokens]
    if cfg.pos_emb == "learned" and positions is not None:
        x = x + p["pos"][positions]
    elif cfg.pos_emb == "sinusoidal" and positions is not None:
        x = x + sinusoidal(positions, cfg.d_model).to(x.dtype)
    return x


def head_init(gen, cfg: ArchConfig, *, dtype=torch.float32, device=None):
    if cfg.tie_embeddings:
        return {}
    return {"w": pm.dense(gen, (cfg.d_model, cfg.vocab_size), dtype=dtype,
                          device=device)}


def head_apply(p, x, embed_params, cfg: ArchConfig):
    w = embed_params["tokens"].T if cfg.tie_embeddings else p["w"]
    return x @ w


def sinusoidal(positions, d_model: int):
    """positions: int tensor (...,) -> (..., d_model) float32."""
    half = d_model // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freq = torch.exp(-math.log(10000.0) * ar / max(half - 1, 1))
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def rope(x, positions, theta: float):
    """Rotary embedding. x: (B, S, H, dh); positions: (S,) or (B, S)."""
    dh = x.shape[-1]
    half = dh // 2
    ar = torch.arange(half, dtype=torch.float32, device=x.device)
    freq = theta ** (-ar / half)
    ang = positions[..., None].float() * freq
    ang = ang[None, :, None, :] if positions.dim() == 1 else ang[:, :, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def frontend_init(gen, cfg: ArchConfig, *, dtype=torch.float32,
                  device=None):
    """Projection from the stub patch embeddings into the backbone."""
    if cfg.frontend is None:
        return {}
    return {"proj": pm.dense(gen, (cfg.d_model, cfg.d_model), dtype=dtype,
                             device=device)}


def frontend_apply(p, embeds, cfg: ArchConfig):
    if cfg.frontend is None:
        return embeds
    return embeds @ p["proj"]
