"""Mamba-1 selective SSM layer, jamba's mixer (arXiv:2312.00752; port of
``repro/models/ssm.py``).

Train and prefill walk the discretized recurrence one position at a
time, a Python loop where the reference runs ``lax.scan``: each step
forms its own decay ``exp(dt_t A)`` (B, d_in, d_state), so the (B, T,
d_in, d_state) tensor is never materialised. Decode is one step from
the cache's conv window and SSM state. The recurrence is plain PyTorch
on the card too: the reference computes it outside any Pallas kernel.

Leaves keep the reference's layouts and key names (``in_proj (d,
2 d_in)``, ``conv_w (d_conv, d_in)``, ``x_proj (d_in, dt_rank + 2
d_state)``, ``dt_w (dt_rank, d_in)``, ``A_log (d_in, d_state)``, ...),
so ``models/convert.py`` carries them across unchanged.

Caches (the static serve engine): ``conv`` (B, d_conv - 1, d_in), the
last inputs of the conv window, in the cache dtype; ``ssm`` (B, d_in,
d_state), always float32. The step overwrites them in place after it
has read them (the reference returns new arrays).

Under a serving mesh (``sharding.serve_layout``) the mixer runs tensor
parallel over its inner dim ``d_in``, which the rules put on ``model``
(``mlp``): a rank holds its block ``[r d_in / m, (r + 1) d_in / m)`` of
every ``mlp`` dim (:func:`tp_block`: both halves of ``in_proj``, the
conv, ``dt_w``, ``dt_b``, ``A_log``, ``D``, the rows of ``x_proj`` and
``out_proj``) and of the caches. ``x_proj`` contracts over ``d_in``, so
its partial products are summed over ``model`` before dt, B and C are
formed; ``out_proj`` is row parallel, its partial outputs summed. The
training step joins the mixer's leaves (``sharding/comm.py``) and runs
the one-process path.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.models import param as pm

MODES = ("train", "prefill", "decode")


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return s, d_in, dt_rank


def mamba_init(gen, cfg: ArchConfig, *, dtype=torch.float32, device=None):
    s, d_in, dt_rank = _dims(cfg)
    d = cfg.d_model
    kw = dict(dtype=dtype, device=device)
    in_proj = pm.dense(gen, (d, 2 * d_in), "embed mlp", **kw)
    conv_w = pm.normal(gen, (s.d_conv, d_in), "conv mlp", std=0.02,
                       **kw)
    x_proj = pm.dense(gen, (d_in, dt_rank + 2 * s.d_state), "mlp _",
                      **kw)
    dt_w = pm.dense(gen, (dt_rank, d_in), "_ mlp", **kw)
    # softplus(dt_b) spread log-uniform in [1e-3, 1e-1] (mamba init).
    u = torch.rand((d_in,), generator=gen, dtype=torch.float32,
                   device=device)
    dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    A = torch.arange(1, s.d_state + 1, dtype=torch.float32,
                     device=device).expand(d_in, s.d_state)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": pm.zeros((d_in,), "mlp", **kw),
        "x_proj": x_proj,
        "dt_w": dt_w,
        "dt_b": pm.tag(dt_bias.to(dtype), "mlp"),
        "A_log": pm.tag(torch.log(A).to(dtype), "mlp state"),
        "D": pm.ones((d_in,), "mlp", **kw),
        "out_proj": pm.dense(gen, (d_in, d), "mlp embed", **kw),
    }


def mamba_cache_init(cfg: ArchConfig, batch: int, *, dtype=torch.float32,
                     device=None):
    s, d_in, _ = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, d_in), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, d_in, s.d_state), dtype=torch.float32,
                           device=device),
    }


MAMBA_CACHE_AXES = {"conv": "batch conv mlp", "ssm": "batch mlp state"}

# The dim of each leaf (counted from the end: a stacked leaf leads with
# its layer dim) that runs over ``d_in``.
INNER_DIM = {"in_proj": -1, "conv_w": -1, "conv_b": -1, "x_proj": -2,
             "dt_w": -1, "dt_b": -1, "A_log": -2, "D": -1, "out_proj": -2}


def tp_block(key: str, t, r: int, m: int):
    """Rank ``r``'s block (of ``m``) of a mixer leaf's ``d_in`` dim
    (:data:`INNER_DIM`): the contiguous block, and for
    ``in_proj`` (..., 2 d_in) the same block of each of its halves (x,
    z) side by side. The rules store ``in_proj``'s ``mlp`` dim as
    contiguous blocks of ``2 d_in`` instead (on 2 ranks, x on one and z
    on the other), so the serving placement takes the rank's block from
    the joined leaf, once, at placement; it holds as many bytes as the
    rules' block."""
    dim = INNER_DIM[key]
    if key == "in_proj":
        halves = t.unflatten(-1, (2, t.shape[-1] // 2))
        n = halves.shape[-1] // m
        return halves.narrow(-1, r * n, n).flatten(-2)
    n = t.shape[dim] // m
    return t.narrow(dim, r * n, n)


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B, T, d_in); w: (d_conv, d_in). A
    cross-correlation over the left-padded input (tap j reads position
    t - (d_conv - 1) + j), as ``conv_general_dilated`` computes it."""
    d_conv, d_in = w.shape
    xp = F.pad(x.transpose(1, 2), (d_conv - 1, 0))  # (B, d_in, T + W - 1)
    out = F.conv1d(xp, w.t()[:, None, :].to(x.dtype), groups=d_in)
    return out.transpose(1, 2) + b


def mamba_apply(p, x, cfg: ArchConfig, *, cache=None, mode: str = "train",
                ctx=None):
    """x: (B, T, d) -> (y, cache). ``mode``: "train" (no cache; starts
    from a zero state), "prefill" (the prompt from an empty cache: the
    conv reads zeros before position 0, the state starts from
    ``cache["ssm"]``) or "decode" (T = 1, the conv window rolled). With a
    cache the new window and state are written into it in place.

    ``ctx``: a ``ShardCtx``. Where ``p`` holds the rank's block of
    ``d_in`` (``conv_w`` narrower than the config's ``d_in``; the
    serving placement, :func:`tp_block`) the mixer runs tensor parallel
    over it with the cache's block: ``x_proj``'s partial products and
    ``out_proj``'s partial outputs summed over ``model``."""
    from repro_torch.sharding import comm

    if mode not in MODES:
        raise ValueError(f"unknown mamba mode {mode!r} {MODES}")
    if (cache is None) != (mode == "train"):
        raise ValueError(f"mamba mode {mode!r} "
                         f"{'needs' if cache is None else 'takes no'} cache")
    s, d_in, dt_rank = _dims(cfg)
    tp = p["conv_w"].shape[-1] != d_in
    if tp and (ctx is None or ctx.tp_size * p["conv_w"].shape[-1] != d_in):
        raise ValueError(
            f"{cfg.name}: the mixer holds {p['conv_w'].shape[-1]} of "
            f"{d_in} inner channels without a ctx that splits them")
    d_in = p["conv_w"].shape[-1]
    B, T, _ = x.shape
    x_in, z = (x @ p["in_proj"]).split(d_in, dim=-1)

    if mode == "decode":
        if T != 1:
            raise ValueError(f"mamba decode takes one position, got {T}")
        window = torch.cat([cache["conv"].to(x_in.dtype), x_in], dim=1)
        new_conv = window[:, 1:]
        xc = (window * p["conv_w"]).sum(1) + p["conv_b"]
        xc = F.silu(xc)[:, None]  # (B, 1, d_in)
    else:
        xc = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"]))
        if mode == "prefill":
            win = s.d_conv - 1
            tail = F.pad(x_in, (0, 0, max(win - T, 0), 0))
            new_conv = tail[:, tail.shape[1] - win:]

    xdb = xc @ p["x_proj"]
    if tp:
        xdb = comm.reduce_from_model(xdb, ctx)
    dt_r = xdb[..., :dt_rank]
    Bm = xdb[..., dt_rank:dt_rank + s.d_state].float()
    Cm = xdb[..., dt_rank + s.d_state:].float()
    dt = F.softplus(dt_r @ p["dt_w"] + p["dt_b"]).float()  # (B, T, d_in)
    A = -torch.exp(p["A_log"].float())  # (d_in, d_state)

    h = (cache["ssm"] if cache is not None else
         torch.zeros((B, d_in, s.d_state), dtype=torch.float32,
                     device=x.device))
    ys = []
    for t in range(T):
        dt_t = dt[:, t]
        dA = torch.exp(dt_t[..., None] * A)  # (B, d_in, d_state)
        dBx = (dt_t * xc[:, t])[..., None] * Bm[:, t, None, :]
        h = dA * h + dBx
        ys.append(torch.bmm(h, Cm[:, t, :, None])[..., 0])
    y = torch.stack(ys, dim=1).to(x.dtype)  # (B, T, d_in)
    y = y + p["D"] * xc
    y = y * F.silu(z)
    out = y @ p["out_proj"]
    if tp:
        out = comm.reduce_from_model(out, ctx)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(h)
    return out, cache
