"""GQA attention: the dense training path, cross-attention onto encoder
states, the static-cache serve path and the paged KV-cache serve paths
(prefill-on-join, decode, and the mixed decode + verify + chunked-prefill
step), and the O(S^2) oracle :func:`reference_attention` (port of
``repro/models/attention.py``).

Shapes keep the JAX layouts: ``wq (d, H, dh)``, ``wk/wv (d, Kh, dh)``,
``wo (H, dh, d)``; static caches ``(B, max_len, Kh, dh)``; pools
``(P, bs, Kh, dh)`` with block 0 the trash block dead rows write into.
Unlike JAX, the cache writes here update the caches and pools IN PLACE
(the JAX engine donated them to the jitted step).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import param as pm
from repro_torch.models.layers import rope


@dataclasses.dataclass(frozen=True)
class MixedMeta:
    """Lane layout of the fused decode + chunked-prefill serve step.

    The row batch is ``R = num_decode + num_chunks * chunk_tokens``
    single-token rows: rows ``[:num_decode]`` are the decode lane (one
    per slot, position = tokens already cached — 0 marks a free or
    prefilling slot), the rest are ``num_chunks`` chunk lanes of
    ``chunk_tokens`` consecutive prompt tokens. ``chunk_lens`` (NC,)
    counts the valid rows per lane (0 = idle lane).

    Speculative verify lanes extend the layout to ``R = num_decode +
    num_verify * verify_tokens + num_chunks * chunk_tokens``: rows
    ``[num_decode : num_decode + num_verify * verify_tokens]`` are
    ``num_verify`` lanes of ``verify_tokens`` consecutive positions (a
    slot's pending token and its drafts), attended like chunk lanes;
    ``verify_lens`` (NV,) counts the valid rows per lane (0 = the slot
    does not verify this tick; its rows write to the trash block).
    """

    num_decode: int
    num_chunks: int
    chunk_tokens: int
    chunk_lens: torch.Tensor  # (num_chunks,) int32
    num_verify: int = 0
    verify_tokens: int = 0
    verify_lens: Optional[torch.Tensor] = None  # (num_verify,) int32


def attention_init(gen, cfg: ArchConfig, *, dtype=torch.float32,
                   device=None):
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": pm.dense(gen, (d, h, dh), "embed heads head_dim", **kw),
        "wk": pm.dense(gen, (d, kh, dh), "embed kv_heads head_dim", **kw),
        "wv": pm.dense(gen, (d, kh, dh), "embed kv_heads head_dim", **kw),
        "wo": pm.dense(gen, (h, dh, d), "heads head_dim embed",
                       fan_in=h * dh, **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = pm.zeros((h, dh), "heads head_dim", **kw)
        p["bk"] = pm.zeros((kh, dh), "kv_heads head_dim", **kw)
        p["bv"] = pm.zeros((kh, dh), "kv_heads head_dim", **kw)
    return p


def pad_heads(p, multiple: int, kv_heads: int | None = None):
    """Zero query heads inserted PER KV GROUP up to a multiple of
    ``multiple`` (the reference's ``pad_heads_multiple``): ``wq``'s head
    dim and ``bq`` gain zero heads after each group's own, ``wo`` zero
    rows, so each original head keeps its kv group under the (Kh, G)
    grouping of the attention kernels. The padded heads' attention
    meets zero ``wo`` rows: the output is exactly preserved. Returns
    ``p`` itself when the head count already divides."""
    H = p["wq"].shape[1]
    Kh = p["wk"].shape[1] if kv_heads is None else kv_heads
    g0, g1 = H // Kh, padded_heads(H, Kh, multiple) // Kh
    if g1 == g0:
        return p

    def grouped(w, axis):
        w = w.movedim(axis, 0)
        rest = w.shape[1:]
        w = w.reshape(Kh, g0, *rest)
        w = torch.cat([w, w.new_zeros((Kh, g1 - g0, *rest))], dim=1)
        return w.reshape(Kh * g1, *rest).movedim(0, axis)

    out = dict(p, wq=grouped(p["wq"], 1), wo=grouped(p["wo"], 0))
    if "bq" in p:
        out["bq"] = grouped(p["bq"], 0)
    return out


def padded_heads(H: int, Kh: int, multiple: int) -> int:
    """The query heads after :func:`pad_heads`: each of the ``Kh``
    groups grown until ``Kh * g`` is a multiple of ``multiple``."""
    if not multiple or H % multiple == 0:
        return H
    g = H // Kh
    while (Kh * g) % multiple:
        g += 1
    return Kh * g


def head_plan(cfg: ArchConfig, m: int, multiple: int = 0):
    """How ``m`` tensor-parallel ranks split an attention layer's heads:
    ``(Hp, Gp, kv)`` — the padded query heads ``Hp`` (rank r runs the
    contiguous block ``[r * Hp / m, (r + 1) * Hp / m)``), their group
    ``Gp = Hp / Kh``, and how a block finds its KV heads: ``"block"``
    (whole groups: the contiguous KV block of ``Hl / Gp`` heads),
    ``"one"`` (the block lies in one group: its one KV head) or
    ``"each"`` (each query head its own KV head, by global index).
    None when ``Hp`` does not divide over ``m`` (every rank then runs
    every head)."""
    H, Kh = cfg.n_heads, cfg.n_kv_heads
    Hp = padded_heads(H, Kh, multiple)
    if Hp % m:
        return None
    Hl, Gp = Hp // m, Hp // Kh
    kv = "block" if Hl % Gp == 0 else "one" if Gp % Hl == 0 else "each"
    return Hp, Gp, kv


def _tp_heads(p, cfg: ArchConfig, ctx, multiple: int):
    """The rank's attention weights under tensor parallelism: its block
    of the (padded) query heads (``wq``, ``bq``, ``wo``) and the KV
    heads they read (``wk``, ``wv``, ``bk``, ``bv``), global query
    head ``h`` reading KV head ``h // Gp`` (:func:`head_plan`). A
    leaf the rules shard over ``model`` (``heads``, ``kv_heads``)
    arrives as the rank's block and is used as it is where the block is
    the one the rank runs; otherwise the whole leaf is taken —
    gathered (:func:`comm.gather_fsdp` over ``model``: the gradient's
    blocks summed back) or, replicated, through
    :func:`comm.copy_to_model` (every peer's partial gradient summed) —
    padded, and cut. Returns None where the heads do not split."""
    from repro_torch.sharding import comm

    m, r = ctx.tp_size, ctx.tp_rank
    plan = head_plan(cfg, m, multiple)
    H, Kh = cfg.n_heads, cfg.n_kv_heads
    q_sharded = p["wq"].shape[1] != H
    kv_sharded = p["wk"].shape[1] != Kh
    if plan is None:
        if q_sharded or kv_sharded:
            raise ValueError(
                f"{cfg.name}: {H} query heads padded to multiple "
                f"{multiple} do not split over {m} model ranks")
        return None
    Hp, Gp, kv = plan
    Hl = Hp // m

    def whole(t, sharded, dim):
        if sharded:
            return comm.gather_fsdp(t, dim, ctx.tp_group, m)
        return comm.copy_to_model(t, ctx)

    out = {}
    qkeys = [k for k in ("wq", "bq", "wo") if k in p]
    qdim = {"wq": 1, "bq": 0, "wo": 0}
    if q_sharded and Hp == H:
        out.update({k: p[k] for k in qkeys})
    else:
        full = {k: whole(p[k], q_sharded, qdim[k]) for k in qkeys}
        full = pad_heads(full, multiple, kv_heads=Kh)
        out.update({k: full[k].narrow(qdim[k], r * Hl, Hl) for k in qkeys})
    kkeys = [k for k in ("wk", "wv", "bk", "bv") if k in p]
    kdim = {"wk": 1, "wv": 1, "bk": 0, "bv": 0}
    if kv_sharded:  # Kh % m == 0, so the block is whole groups
        out.update({k: p[k] for k in kkeys})
    else:
        a = r * Hl
        for k in kkeys:
            t = comm.copy_to_model(p[k], ctx)
            if kv == "block":
                t = t.narrow(kdim[k], a // Gp, Hl // Gp)
            elif kv == "one":
                t = t.narrow(kdim[k], a // Gp, 1)
            else:
                idx = torch.arange(a, a + Hl, device=t.device) // Gp
                t = t.index_select(kdim[k], idx)
            out[k] = t
    return out


def _project(x, w):
    """einsum("bsd,dhk->bshk") as one matmul."""
    B, S, d = x.shape
    return (x.reshape(B * S, d) @ w.reshape(d, -1)).reshape(
        B, S, *w.shape[1:]
    )


def attention_apply(
    p,
    x,
    cfg: ArchConfig,
    *,
    cache=None,
    cache_index=None,
    block_tables=None,
    mixed: MixedMeta | None = None,
    causal: bool = True,
    kv_x=None,
    implementation: str = "auto",
    pad_heads_multiple: int = 0,
    ctx=None,
):
    """Self- or cross-attention. Returns (y, cache).

    ``ctx`` (a ``ShardCtx``; the training paths with ``cache`` None, the
    serving paths under ``sharding.serve_layout``'s ctx): with a
    ``model`` axis, each rank runs its contiguous block of the (padded)
    query heads and the KV heads they read (:func:`_tp_heads`) through
    the kernels at the local head counts; the input is column-parallel,
    ``wo`` row-parallel, the partial outputs added over ``model``. The
    paged pools then hold the rank's KV heads; a static cache its KV
    heads, or its block of positions of every KV head
    (:func:`_static_attention`).

    ``pad_heads_multiple``: zero query heads padded up to a multiple of
    this (:func:`pad_heads`; e.g. qwen2.5's 40/8 heads become 48/8 at
    16), through every path below; the output is exactly preserved.

    ``kv_x`` set — cross-attention onto the encoder states kv_x (B, Se,
    d): q is projected from x, k and v from kv_x; no rope, no cache,
    never causal, always through ``ops.flash_attention`` (the flash
    kernels, forward and backward, on "cuda"), also for the single query
    of a decode step. As in the reference, the encoder's k/v are
    recomputed at every call: there is no cross-KV cache.

    ``cache`` None — the dense training path: x (B, S, d) at positions
    0..S-1 through ``ops.flash_attention`` (the flash kernels, forward
    and backward, on "cuda"); differentiable. ``causal`` False is the
    encoder's bidirectional attention (ViT: learned positions, no rope).

    ``cache`` set and ``block_tables`` None — the static engine's dense
    cache ``{"k", "v"}`` of (B, max_len, Kh, dh): this step's k/v are
    written at ``cache_index`` (an int, shared by the batch) onward, in
    place. A prefill (Sq > 1) attends over its own fresh k/v through
    ``ops.flash_attention`` (causal, rows at ``cache_index`` onward; it
    assumes an empty cache, as ``prefill`` drives it); a decode step
    (Sq = 1) attends over the cache's first ``cache_index + 1`` positions
    through the plain :func:`_decode_attention` (the reference computes
    it outside any kernel).

    Otherwise paged self-attention over the KV block pools:

    ``mixed`` set — the fused decode + verify + chunked-prefill step:
    ``cache_index`` carries PER-ROW absolute positions and
    ``block_tables`` per-row tables; all rows write k/v through ONE
    scatter (:func:`paged_row_write`, dead rows land in the trash block),
    then the decode lane reads via ``ops.decode_attention``, and the
    verify lanes and the chunk lanes via ``ops.prefill_attention``.
    Later lanes of one request see earlier lanes' writes of the same
    step, because the writes come first.

    ``mixed`` None and Sq > 1 — prefill-on-join: ONE request (B = 1)
    whose bucketed prompt (Sq a multiple of the block size) is written
    into its slot's blocks (:func:`paged_prefill_write`, in place); it
    attends over its own fresh k/v through ``ops.flash_attention``
    (causal, positions 0..Sq-1). The padded tail's k/v land in the
    slot's blocks and stay masked by the slot's length.

    ``mixed`` None and Sq = 1 — decode only: ``cache_index`` is the
    per-slot (B,) length vector, each slot writes one token and attends
    over its blocks (free slots, length 0, attend nothing and give
    zeros).

    ``implementation``: "auto" | "cuda" | "eager" (see kernels/ops.py).
    The paged cache dict comes back holding the same pool tensors,
    updated in place.
    """
    from repro_torch.kernels import ops
    from repro_torch.sharding import comm

    local = None
    if ctx is not None and ctx.tp_size > 1 and (
            cache is None or ctx.serve is not None):
        local = _tp_heads(p, cfg, ctx, pad_heads_multiple)
    if local is not None:
        p = local
        x = comm.copy_to_model(x, ctx)
        if kv_x is not None:
            kv_x = comm.copy_to_model(kv_x, ctx)

        def out(y):
            return comm.reduce_from_model(_out(y, p["wo"]), ctx)
    else:
        p = pad_heads(p, pad_heads_multiple)

        def out(y):
            return _out(y, p["wo"])
    if kv_x is not None:
        if cache is not None or block_tables is not None:
            raise ValueError("cross-attention keeps no cache")
        q = _project(x, p["wq"])
        k = _project(kv_x, p["wk"])
        v = _project(kv_x, p["wv"])
        if "bq" in p:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        y = ops.flash_attention(q, k, v, causal=False,
                                implementation=implementation)
        return out(y), None
    B, Sq, _ = x.shape
    if block_tables is not None and Sq != 1 and (mixed is not None
                                                 or B != 1):
        raise ValueError(
            "paged prefill admits one request at a time (B == 1); the "
            "mixed step runs single-token rows"
        )
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cache is None:
        if cfg.pos_emb == "rope":
            positions = torch.arange(Sq, device=x.device)
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        y = ops.flash_attention(q, k, v, causal=causal,
                                implementation=implementation)
        return out(y), None
    if block_tables is None:
        mode = None
        if ctx is not None and ctx.tp_size > 1 and ctx.serve is not None:
            mode = ctx.serve.cache
        y = _static_attention(q, k, v, cfg, cache, int(cache_index), causal,
                              implementation, mode=mode, ctx=ctx,
                              tp=local is not None,
                              multiple=pad_heads_multiple)
        return out(y), cache
    pool_k, pool_v = cache["k"], cache["v"]
    if mixed is None and Sq > 1:
        if cfg.pos_emb == "rope":
            positions = torch.arange(Sq, device=x.device)
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        paged_prefill_write(pool_k, k, block_tables)
        paged_prefill_write(pool_v, v, block_tables)
        y = ops.flash_attention(q, k, v, causal=True,
                                implementation=implementation)
        return out(y), cache
    if mixed is None:
        lengths = cache_index
        if cfg.pos_emb == "rope":
            q = rope(q, lengths[:, None], cfg.rope_theta)
            k = rope(k, lengths[:, None], cfg.rope_theta)
        paged_decode_write(pool_k, k, block_tables, lengths)
        paged_decode_write(pool_v, v, block_tables, lengths)
        # Live slots attend their freshly written token too; free slots
        # keep length 0 (their write went to the trash block).
        y = ops.decode_attention(
            q, pool_k, pool_v, block_tables,
            lengths + (lengths > 0).to(lengths.dtype),
            implementation=implementation,
        )
        return out(y), cache

    positions = cache_index  # (R,) absolute write position per row
    if cfg.pos_emb == "rope":
        q = rope(q, positions[:, None], cfg.rope_theta)
        k = rope(k, positions[:, None], cfg.rope_theta)
    B_dec, NC, C = mixed.num_decode, mixed.num_chunks, mixed.chunk_tokens
    NV, K1 = mixed.num_verify, mixed.verify_tokens
    v0, c0 = B_dec, B_dec + NV * K1
    parts = []
    if B_dec:
        dec_live = positions[:B_dec] > 0
        parts.append(dec_live)
    if NV:
        ver_live = (
            torch.arange(K1, device=x.device)[None, :]
            < mixed.verify_lens[:, None]
        )
        parts.append(ver_live.reshape(-1))
    if NC:
        chunk_live = (
            torch.arange(C, device=x.device)[None, :]
            < mixed.chunk_lens[:, None]
        )
        parts.append(chunk_live.reshape(-1))
    live = torch.cat(parts)
    # ONE cache-write path for all lanes: a single per-row scatter.
    paged_row_write(pool_k, k, block_tables, positions, live)
    paged_row_write(pool_v, v, block_tables, positions, live)
    ys = []
    if B_dec:
        ys.append(ops.decode_attention(
            q[:B_dec], pool_k, pool_v, block_tables[:B_dec],
            positions[:B_dec] + dec_live.to(positions.dtype),
            implementation=implementation,
        ))
    if NV:
        # Verify lanes: K1 rows a slot (pending token + drafts); row j
        # attends pool positions <= start + j, the drafts written above
        # and everything already cached.
        qv = q[v0:c0, 0].reshape(NV, K1, *q.shape[2:])
        vtab = block_tables[v0:c0].reshape(NV, K1, -1)[:, 0]
        vstart = positions[v0:c0].reshape(NV, K1)[:, 0]
        y_v = ops.prefill_attention(
            qv, pool_k, pool_v, vtab, vstart, mixed.verify_lens,
            implementation=implementation,
        )
        ys.append(y_v.reshape(NV * K1, 1, *y_v.shape[2:]))
    if NC:
        # Chunk rows attend every pool position <= their own: prefix
        # blocks, earlier chunks and the chunk itself (written above).
        qc = q[c0:, 0].reshape(NC, C, *q.shape[2:])
        ctab = block_tables[c0:].reshape(NC, C, -1)[:, 0]
        cstart = positions[c0:].reshape(NC, C)[:, 0]
        y_ch = ops.prefill_attention(
            qc, pool_k, pool_v, ctab, cstart, mixed.chunk_lens,
            implementation=implementation,
        )
        ys.append(y_ch.reshape(NC * C, 1, *y_ch.shape[2:]))
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=0)
    return out(y), cache


def _static_attention(q, k, v, cfg, cache, index: int, causal: bool,
                      implementation: str, *, mode=None, ctx=None,
                      tp: bool = False, multiple: int = 0):
    """The static-cache branch of :func:`attention_apply`; returns the
    attention's output before ``wo``. ``mode`` (the serving ctx's
    ``ServePlan.cache`` under tensor parallelism, else None): ``"heads"``
    — the cache holds this rank's KV heads, the step runs on them as
    one process does; ``"seq"`` — the cache holds every KV head at this
    rank's block of positions; ``"replicated"`` — every head and
    position. In the last two the step's k and v (and a decode step's
    q) are gathered over ``model`` in one all-gather
    (:func:`_gather_heads`) and each position is written by the rank
    that holds it; a prefill attends over its fresh k/v at the rank's
    heads, a decode step over the cache (:func:`_cache_decode`).
    ``tp``: q, k and v hold the rank's heads (``_tp_heads``)."""
    from repro_torch.kernels import ops

    Sq = q.shape[1]
    if cfg.pos_emb == "rope":
        positions = torch.arange(index, index + Sq, device=q.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    if mode not in ("seq", "replicated"):
        ck[:, index:index + Sq] = k.to(ck.dtype)
        cv[:, index:index + Sq] = v.to(cv.dtype)
        if Sq > 1:
            # Prefill: attend over the LOCAL fresh k/v, not the cache.
            return ops.flash_attention(q, k, v, causal=causal,
                                       q_offset=index,
                                       implementation=implementation)
        return _decode_attention(q, ck, cv, index + 1)
    qa, ka, va = q, k, v
    if tp:
        parts = [k, v] + ([q] if Sq == 1 else [])
        ka, va, *qa = _gather_heads(parts, ctx)
        pick = _kv_pick(cfg, ctx.tp_size, multiple)
        if pick != list(range(ka.shape[2])):
            idx = torch.tensor(pick, device=q.device)
            ka, va = ka.index_select(2, idx), va.index_select(2, idx)
    S_l = ck.shape[1]
    lo = ctx.tp_rank * S_l if mode == "seq" else 0
    a, b = max(index, lo), min(index + Sq, lo + S_l)
    if a < b:
        ck[:, a - lo:b - lo] = ka[:, a - index:b - index].to(ck.dtype)
        cv[:, a - lo:b - lo] = va[:, a - index:b - index].to(cv.dtype)
    if Sq > 1:
        return ops.flash_attention(q, k, v, causal=causal, q_offset=index,
                                   implementation=implementation)
    y = _cache_decode(qa[0] if tp else q, ck, cv, index + 1, lo, ctx,
                      seq=mode == "seq")
    if tp:
        y = y.narrow(2, ctx.tp_rank * q.shape[2], q.shape[2])
    return y.to(q.dtype)


def _kv_pick(cfg, m: int, multiple: int) -> list:
    """Where each global KV head lies in the ``model`` gather of the
    ranks' KV blocks (:func:`head_plan`: rank r reads the KV heads of
    query heads ``[r Hl, (r + 1) Hl)``): the first place holding it."""
    Hp, Gp, kv = head_plan(cfg, m, multiple)
    Hl = Hp // m
    flat = []
    for r in range(m):
        a = r * Hl
        if kv == "block":
            flat += range(a // Gp, a // Gp + Hl // Gp)
        elif kv == "one":
            flat.append(a // Gp)
        else:
            flat += [(a + i) // Gp for i in range(Hl)]
    return [flat.index(j) for j in range(cfg.n_kv_heads)]


def _gather_heads(ts, ctx) -> list:
    """Each of ``ts`` (B, S, n_i, dh; one dtype) joined over ``model``
    along its heads in rank order, through one all-gather."""
    from repro_torch.sharding import comm

    sizes = [t.shape[2] for t in ts]
    g = comm.gather_replicated(torch.cat(ts, 2), 2, ctx, "cache_all_gather")
    B, S, _, dh = g.shape
    g = g.reshape(B, S, ctx.tp_size, sum(sizes), dh)
    return [t.reshape(B, S, -1, dh) for t in g.split(sizes, 3)]


def decode_partial(q, k, v, n: int):
    """The partial softmax of one query a row over the first ``n``
    positions of a block of the cache. q: (B, 1, H, dh); k, v: (B, S_l,
    Kh, dh). Returns (u (B, Kh, G, dh) the unnormalised sum of
    ``exp(s - mx) v``, mx (B, Kh, G) the largest score, l (B, Kh, G) the
    sum of ``exp(s - mx)``), float32; a block with no position (``n`` 0)
    gives u = l = 0 and mx = -inf."""
    B, _, H, dh = q.shape
    Kh = k.shape[2]
    qg = q.float().reshape(B, Kh, H // Kh, dh)
    if n == 0:
        z = qg.new_zeros((B, Kh, H // Kh))
        return torch.zeros_like(qg), z - float("inf"), z
    s = torch.einsum("bkgd,btkd->bkgt", qg, k[:, :n].float()) * dh ** -0.5
    mx = s.max(-1).values
    p = torch.exp(s - mx[..., None])
    return torch.einsum("bkgt,btkd->bkgd", p, v[:, :n].float()), mx, \
        p.sum(-1)


def combine_partials(u, mx, l):
    """One softmax's output from the partials of the blocks of a
    sequence, stacked on dim 0 (:func:`decode_partial`): each block's
    sums rescaled to the largest score by log-sum-exp, summed in block
    order. A block with no position (mx -inf, l 0) weighs 0; at least
    one block must hold a position."""
    top = mx.max(0).values
    w = torch.where(torch.isfinite(mx), torch.exp(mx - top),
                    torch.zeros_like(mx))
    return (u * w[..., None]).sum(0) / (l * w).sum(0)[..., None]


def _cache_decode(q, k, v, kv_len: int, lo: int, ctx, *, seq: bool):
    """A decode step over a cache holding every KV head at positions
    ``[lo, lo + S_l)``, q (B, 1, H, dh) every (padded) query head: the
    partial softmax over the block's valid positions; with ``seq`` the
    partials of every ``model`` rank gathered and combined
    (:func:`combine_partials`). Plain PyTorch in float32, as
    :func:`_decode_attention`. Returns (B, 1, H, dh) float32."""
    from repro_torch.sharding import comm

    B, _, H, dh = q.shape
    n = min(max(kv_len - lo, 0), k.shape[1])
    u, mx, l = decode_partial(q, k, v, n)
    if seq:
        part = torch.cat([u, mx[..., None], l[..., None]], dim=-1)
        part = comm.gather_replicated(part[None], 0, ctx, "softmax_combine")
        y = combine_partials(part[..., :dh], part[..., dh], part[..., dh + 1])
    else:
        y = u / l[..., None]
    return y.reshape(B, 1, H, dh)


def _decode_attention(q, k, v, kv_len: int):
    """q: (B, 1, H, dh); k, v: (B, S, Kh, dh). Softmax over the first
    ``kv_len`` (>= 1) positions, shared by the batch. Plain PyTorch in
    float32, as the reference computes it outside any kernel. Returns
    (B, 1, H, dh) in q's dtype."""
    B, _, H, dh = q.shape
    Kh = k.shape[2]
    qg = q.float().reshape(B, Kh, H // Kh, dh)
    kk, vv = k[:, :kv_len].float(), v[:, :kv_len].float()
    p = torch.softmax(torch.einsum("bkgd,btkd->bkgt", qg, kk) * dh ** -0.5,
                      dim=-1)
    y = torch.einsum("bkgt,btkd->bkgd", p, vv)
    return y.reshape(B, 1, H, dh).to(q.dtype)


def reference_attention(q, k, v, *, causal=True, q_offset=0, kv_len=None):
    """O(S^2)-memory oracle for tests: q (B, Sq, H, dh), k/v (B, Skv,
    Kh, dh); query i sits at position ``q_offset + i``, keys at
    ``kv_len`` or later are masked. Scores and the weighted sum in
    float32; returns (B, Sq, H, dh) in q's dtype."""
    B, Sq, H, dh = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Kh, H // Kh, dh).float()
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) * dh ** -0.5
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        mask = mask & (kv_pos[None, :] < kv_len)
    if causal:
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, dh).to(q.dtype)


CACHE_AXES = {"k": "batch cache_seq kv_heads head_dim",
              "v": "batch cache_seq kv_heads head_dim"}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device=None):
    """The static engine's dense KV cache, (B, max_len, Kh, dh) each."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _out(y, wo):
    """einsum("bshk,hkd->bsd") as one matmul."""
    B, S, H, dh = y.shape
    return (y.reshape(B * S, H * dh) @ wo.reshape(H * dh, -1)).reshape(
        B, S, -1
    )


# ---------------------------------------------------------------------------
# paged KV cache
# ---------------------------------------------------------------------------


def init_paged_cache(cfg: ArchConfig, num_blocks: int, block_size: int, *,
                     dtype=torch.bfloat16, device=None):
    """Global KV block pool: fixed-size blocks owned by sequence slots via
    per-slot block tables. Block 0 is the trash block."""
    shape = (num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def paged_prefill_write(pool, kv, block_table):
    """Write a full prompt's k or v into its slot's blocks, in place.
    pool: (P, bs, Kh, dh); kv: (1, S, Kh, dh) with S a multiple of bs
    (the engine buckets prompt lengths; the padded tail stays masked by
    the slot's length until decode overwrites it); block_table: (1, nb),
    nb >= S // bs."""
    bs = pool.shape[1]
    S = kv.shape[1]
    if S % bs:
        raise ValueError(
            f"paged prefill length ({S}) must be a multiple of the "
            f"block size ({bs}); bucket the prompt before prefill"
        )
    nbu = S // bs
    pool[block_table[0, :nbu].long()] = kv[0].reshape(
        nbu, bs, *kv.shape[2:]).to(pool.dtype)
    return pool


def paged_decode_write(pool, kv, block_tables, lengths):
    """Scatter one decode token's k or v per slot into the pool, in
    place. pool: (P, bs, Kh, dh); kv: (B, 1, Kh, dh); block_tables:
    (B, nb); lengths: (B,) write position per slot. Free slots (length 0,
    all-zero table rows) land in trash block 0 — never read."""
    P, bs = pool.shape[:2]
    blk = (lengths // bs).long()
    bids = torch.gather(block_tables, 1, blk[:, None])[:, 0].long()
    flat = pool.view(P * bs, *pool.shape[2:])
    flat[bids * bs + (lengths % bs).long()] = kv[:, 0].to(pool.dtype)
    return pool


def paged_row_write(pool, kv, row_tables, positions, live):
    """Scatter one token per ROW into the pool at its absolute position,
    in place — the single cache-write path of the mixed step.

    pool: (P, bs, Kh, dh); kv: (R, 1, Kh, dh); row_tables: (R, nb);
    positions: (R,); live: (R,) bool — dead rows (free slots, padded
    chunk rows, idle lanes) land in trash block 0, which is never read,
    so their colliding writes there are harmless. Positions are clamped
    into the table so padded rows stay in bounds.
    """
    P, bs = pool.shape[:2]
    nb = row_tables.shape[1]
    blk = torch.clamp(positions // bs, 0, nb - 1).long()
    bids = torch.gather(row_tables, 1, blk[:, None])[:, 0].long()
    bids = torch.where(live, bids, torch.zeros_like(bids))
    off = torch.where(live, (positions % bs).long(), torch.zeros_like(bids))
    flat = pool.view(P * bs, *pool.shape[2:])
    flat[bids * bs + off] = kv[:, 0].to(pool.dtype)
    return pool
