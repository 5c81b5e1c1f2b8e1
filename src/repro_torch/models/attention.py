"""GQA attention: the dense training path and the paged KV-cache serve
path (port of those subsets of ``repro/models/attention.py``).

Shapes keep the JAX layouts: ``wq (d, H, dh)``, ``wk/wv (d, Kh, dh)``,
``wo (H, dh, d)``; pools ``(P, bs, Kh, dh)`` with block 0 the trash
block dead rows write into. Unlike JAX, the cache writes here update the
pools IN PLACE (the JAX engine donated them to the jitted step).

The static-cache prefill/decode path and cross-attention are queued in
ROADMAP.md (static engine, encoder-decoder family).
"""
from __future__ import annotations

import dataclasses

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
    counts the valid rows per lane (0 = idle lane). Speculative verify
    lanes are queued in ROADMAP.md.
    """

    num_decode: int
    num_chunks: int
    chunk_tokens: int
    chunk_lens: torch.Tensor  # (num_chunks,) int32


def attention_init(gen, cfg: ArchConfig, *, dtype=torch.float32,
                   device=None):
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": pm.dense(gen, (d, h, dh), **kw),
        "wk": pm.dense(gen, (d, kh, dh), **kw),
        "wv": pm.dense(gen, (d, kh, dh), **kw),
        "wo": pm.dense(gen, (h, dh, d), fan_in=h * dh, **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = pm.zeros((h, dh), **kw)
        p["bk"] = pm.zeros((kh, dh), **kw)
        p["bv"] = pm.zeros((kh, dh), **kw)
    return p


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
    implementation: str = "auto",
):
    """Self-attention. Returns (y, cache).

    ``cache`` None — the dense training path: x (B, S, d) at positions
    0..S-1 through ``ops.flash_attention`` (the flash kernels, forward
    and backward, on "cuda"); differentiable. ``causal`` False is the
    encoder's bidirectional attention (ViT: learned positions, no rope).

    Otherwise paged self-attention over single-token rows x (B, 1, d):

    ``mixed`` set — the fused decode + chunked-prefill step:
    ``cache_index`` carries PER-ROW absolute positions and
    ``block_tables`` per-row tables; all rows write k/v through ONE
    scatter (:func:`paged_row_write`, dead rows land in the trash block),
    then the decode lane reads via ``ops.decode_attention`` and the chunk
    lanes via ``ops.prefill_attention``. Later lanes of one request see
    earlier lanes' writes of the same step, because the writes come
    first.

    ``mixed`` None — decode only: ``cache_index`` is the per-slot (B,)
    length vector, each slot writes one token and attends over its
    blocks (free slots, length 0, attend nothing and give zeros).

    ``implementation``: "auto" | "cuda" | "eager" (see kernels/ops.py).
    The paged cache dict comes back holding the same pool tensors,
    updated in place.
    """
    from repro_torch.kernels import ops

    B, Sq, _ = x.shape
    if cache is not None and Sq != 1:
        raise NotImplementedError(
            "the paged path runs single-token rows; prefill into a cache "
            "(the static engine) is queued in ROADMAP.md"
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
        return _out(y, p["wo"]), None
    pool_k, pool_v = cache["k"], cache["v"]
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
        return _out(y, p["wo"]), cache

    positions = cache_index  # (R,) absolute write position per row
    if cfg.pos_emb == "rope":
        q = rope(q, positions[:, None], cfg.rope_theta)
        k = rope(k, positions[:, None], cfg.rope_theta)
    B_dec, NC, C = mixed.num_decode, mixed.num_chunks, mixed.chunk_tokens
    parts = []
    if B_dec:
        dec_live = positions[:B_dec] > 0
        parts.append(dec_live)
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
    if NC:
        # Chunk rows attend every pool position <= their own: prefix
        # blocks, earlier chunks and the chunk itself (written above).
        qc = q[B_dec:, 0].reshape(NC, C, *q.shape[2:])
        ctab = block_tables[B_dec:].reshape(NC, C, -1)[:, 0]
        cstart = positions[B_dec:].reshape(NC, C)[:, 0]
        y_ch = ops.prefill_attention(
            qc, pool_k, pool_v, ctab, cstart, mixed.chunk_lens,
            implementation=implementation,
        )
        ys.append(y_ch.reshape(NC * C, 1, *y_ch.shape[2:]))
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=0)
    return _out(y, p["wo"]), cache


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
