"""Top-level model builders for decoder-only and encoder-only attention
stacks (port of the training and paged-serving subsets of
``repro/models/model_zoo.py``): ``init_params``, ``forward_train``,
``loss_fn``, ``init_paged_serve_cache``, ``paged_mixed_step`` and
``paged_decode_step``.

Batch formats
  decoder_only : ``{"tokens": (B, S), "targets": (B, S)}`` with -1
                 marking masked-out targets;
  encoder_only : ``{"patch_embeds": (B, P, d), "labels": (B,)}`` (ViT).

The chunked cross-entropy (``ce_chunk``), remat, the static-cache
prefill/decode and the speculative verify step are queued in
ROADMAP.md.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs import ArchConfig
from repro_torch.kernels.ops import IMPLEMENTATIONS
from repro_torch.models import param as pm
from repro_torch.models import stack as stk
from repro_torch.models.attention import MixedMeta
from repro_torch.models.layers import (
    embed_apply,
    embed_init,
    frontend_apply,
    frontend_init,
    head_apply,
    head_init,
    norm_apply,
    norm_init,
)


@dataclasses.dataclass(frozen=True)
class ApplyCfg:
    """Runtime knobs. ``moe_impl``/``attn_impl`` in ``auto|cuda|eager``:
    ``resolve(device)`` pins "auto" to the CUDA kernels on a CUDA device
    and to the plain PyTorch versions elsewhere."""

    dispatch: str = "gather"  # moe dispatch: gather | einsum | sorted
    moe_impl: str = "auto"
    attn_impl: str = "auto"

    def resolve(self, device) -> "ApplyCfg":
        for impl in (self.moe_impl, self.attn_impl):
            if impl not in IMPLEMENTATIONS:
                raise ValueError(
                    f"unknown implementation {impl!r} {IMPLEMENTATIONS}"
                )
        pin = "cuda" if torch.device(device).type == "cuda" else "eager"
        return dataclasses.replace(
            self,
            moe_impl=pin if self.moe_impl == "auto" else self.moe_impl,
            attn_impl=pin if self.attn_impl == "auto" else self.attn_impl,
        )


def _check_structure(cfg: ArchConfig, *ok: str) -> None:
    if cfg.structure not in ok:
        raise NotImplementedError(
            f"{cfg.name} is {cfg.structure}: this entry point runs "
            f"{' and '.join(ok)} models (the encoder-decoder family is "
            "queued in ROADMAP.md)"
        )


def init_params(gen, cfg: ArchConfig, *, dtype=torch.float32, device=None):
    """Random parameters with the JAX key paths and layouts.

    ``gen`` is a ``torch.Generator`` on ``device`` or an int seed.
    ``device`` defaults to "cuda" and raises without a card."""
    _check_structure(cfg, "decoder_only", "encoder_only")
    device = resolve_device(device)
    if isinstance(gen, int):
        gen = torch.Generator(device=device).manual_seed(gen)
    kw = dict(dtype=dtype, device=device)
    if cfg.structure == "encoder_only":
        return {
            "frontend": frontend_init(gen, cfg, **kw),
            "pos": pm.normal(gen, (cfg.n_frontend_positions, cfg.d_model),
                             **kw),
            "stack": stk.stack_init(gen, cfg, stk.layer_descs(cfg), **kw),
            "final_norm": norm_init(cfg, device=device),
            "head": {"w": pm.dense(gen, (cfg.d_model, cfg.vocab_size),
                                   **kw)},
        }
    return {
        "embed": embed_init(gen, cfg, **kw),
        "stack": stk.stack_init(gen, cfg, stk.layer_descs(cfg), **kw),
        "final_norm": norm_init(cfg, device=device),
        "head": head_init(gen, cfg, **kw),
    }


def forward_train(params, batch, cfg: ArchConfig, *,
                  ac: ApplyCfg = ApplyCfg()):
    """The training forward, through the flash-attention and expert-FFN
    kernels (and their backward kernels under autograd) on a CUDA
    device. Decoder-only: causal LM over ``batch["tokens"] (B, S)`` at
    positions 0..S-1, logits (B, S, V). Encoder-only (ViT): the patch
    frontend plus learned positions, the bidirectional stack (Expert
    Choice in its MoE layers), the final norm, global average pooling
    and the class head, logits (B, V). Returns (logits float32,
    metrics)."""
    _check_structure(cfg, "decoder_only", "encoder_only")
    if cfg.structure == "encoder_only":
        pe = batch["patch_embeds"]
        ac = ac.resolve(pe.device)
        x = frontend_apply(params["frontend"], pe, cfg)
        x = x + params["pos"][None]
        x, mets, _ = stk.stack_apply(
            params["stack"], x, cfg, stk.layer_descs(cfg), causal=False,
            router_kind=stk.stack_router_kind(cfg, stack="encoder"),
            dispatch=ac.dispatch, moe_impl=ac.moe_impl,
            attn_impl=ac.attn_impl,
        )
        x = norm_apply(params["final_norm"], x, cfg)
        pooled = x.mean(dim=1)  # global average pooling (paper §2.2)
        return (pooled @ params["head"]["w"]).float(), mets
    tokens = batch["tokens"].long()
    ac = ac.resolve(tokens.device)
    S = tokens.shape[1]
    x = embed_apply(params["embed"], tokens, cfg,
                    positions=torch.arange(S, device=tokens.device))
    x, mets, _ = _stack(params, x, cfg, ac)
    x = norm_apply(params["final_norm"], x, cfg)
    return head_apply(params.get("head", {}), x, params["embed"],
                      cfg).float(), mets


def loss_fn(params, batch, cfg: ArchConfig, *, ac: ApplyCfg = ApplyCfg()):
    """Returns (loss, metrics): mean cross-entropy over the valid
    targets (``targets >= 0``), or over the images' ``labels`` for an
    encoder-only model, plus the weighted MoE aux and z losses."""
    logits, mets = forward_train(params, batch, cfg, ac=ac)
    logp = torch.log_softmax(logits, dim=-1)
    if cfg.structure == "encoder_only":
        labels = batch["labels"].long()
        ce = -torch.gather(logp, -1, labels[:, None]).mean()
    else:
        targets = batch["targets"].long()
        valid = targets >= 0
        ce_tok = -torch.gather(logp, -1,
                               targets.clamp(min=0)[..., None])[..., 0]
        denom = torch.clamp(valid.sum(), min=1)
        ce = torch.where(valid, ce_tok,
                         torch.zeros_like(ce_tok)).sum() / denom
    loss = ce + mets["aux_loss"] + mets["z_loss"]
    out = dict(mets)
    out.update(loss=loss, ce=ce)
    return loss, out


def init_paged_serve_cache(cfg: ArchConfig, num_blocks: int,
                           block_size: int, *, dtype=torch.bfloat16,
                           device=None):
    """Per-layer KV block pools addressed by shared per-slot block
    tables. ``device`` defaults to "cuda" and raises without a card."""
    _check_structure(cfg, "decoder_only")
    device = resolve_device(device)
    return {"stack": stk.stack_paged_cache_init(
        cfg, stk.layer_descs(cfg), num_blocks, block_size, dtype=dtype,
        device=device,
    )}


def _stack(params, x, cfg, ac: ApplyCfg, **kw):
    return stk.stack_apply(
        params["stack"], x, cfg, stk.layer_descs(cfg),
        router_kind=stk.stack_router_kind(cfg, stack="decoder"),
        dispatch=ac.dispatch,
        moe_impl=ac.moe_impl, attn_impl=ac.attn_impl, **kw,
    )


def _logits(params, h, cfg):
    h = norm_apply(params["final_norm"], h, cfg)
    return head_apply(params.get("head", {}), h, params["embed"],
                      cfg).float()


def paged_decode_step(params, tokens, cache, block_tables, lengths,
                      cfg: ArchConfig, *, ac: ApplyCfg = ApplyCfg()):
    """One continuous-batching decode step over the slot batch.

    tokens: (B, 1); block_tables: (B, nb); lengths: (B,) tokens already
    cached per slot (0 = free slot: masked out of routing, write to the
    trash block). Updates the pools in place; returns (cache, logits
    (B, 1, V))."""
    ac = ac.resolve(tokens.device)
    live = lengths > 0
    x = embed_apply(params["embed"], tokens, cfg,
                    positions=lengths[:, None])
    x, _, cache["stack"] = _stack(
        params, x, cfg, ac, cache=cache["stack"], cache_index=lengths,
        block_tables=block_tables, token_mask=live[:, None],
    )
    return cache, _logits(params, x, cfg)


def paged_mixed_step(params, dec_tokens, chunk_tokens, cache, dec_tables,
                     dec_lengths, chunk_tables, chunk_starts, chunk_lens,
                     cfg: ArchConfig, *, ac: ApplyCfg = ApplyCfg()):
    """One fused continuous-batching step: the decode batch AND the
    pending prefill chunks through a single forward.

    dec_tokens: (B, 1); dec_lengths: (B,) tokens already cached (0 =
    slot free or prefilling); dec_tables: (B, nb). chunk_tokens:
    (NC, C); chunk_tables: (NC, nb); chunk_starts: (NC,) absolute
    position of each lane's first token; chunk_lens: (NC,) valid tokens
    (0 = idle lane). The R = B + NC*C rows write their k/v through one
    paged scatter — into the pools IN PLACE, where the JAX engine
    donated them — then decode rows read through the paged decode
    kernel and chunk rows through the paged prefill kernel.

    Returns ``(cache, logits (B + NC, V))``: rows [:B] are the decode
    slots' next-token logits, rows [B:] each chunk lane's logits at its
    last valid row."""
    ac = ac.resolve(dec_tokens.device)
    dev = dec_tokens.device
    B = dec_tokens.shape[0]
    NC, C = chunk_tokens.shape
    i32 = torch.int32
    dec_lengths = dec_lengths.to(i32)
    chunk_starts = chunk_starts.to(i32)
    chunk_lens = chunk_lens.to(i32)
    ar = torch.arange(C, device=dev, dtype=i32)
    chunk_live = ar[None, :] < chunk_lens[:, None]
    tokens = torch.cat([dec_tokens.reshape(B),
                        chunk_tokens.reshape(NC * C)])[:, None].long()
    positions = torch.cat([
        dec_lengths, (chunk_starts[:, None] + ar[None, :]).reshape(NC * C),
    ])
    row_tables = torch.cat(
        [dec_tables, torch.repeat_interleave(chunk_tables, C, dim=0)]
    ).to(i32)
    token_mask = torch.cat([dec_lengths > 0,
                            chunk_live.reshape(NC * C)])[:, None]
    x = embed_apply(params["embed"], tokens, cfg,
                    positions=positions[:, None])
    x, _, cache["stack"] = _stack(
        params, x, cfg, ac, cache=cache["stack"], cache_index=positions,
        block_tables=row_tables, token_mask=token_mask,
        mixed=MixedMeta(num_decode=B, num_chunks=NC, chunk_tokens=C,
                        chunk_lens=chunk_lens),
    )
    d = x.shape[-1]
    last = torch.clamp(chunk_lens - 1, 0, C - 1).long()
    xc = x[B:, 0].reshape(NC, C, d)[torch.arange(NC, device=dev), last]
    h = torch.cat([x[:B, 0], xc])[:, None]
    return cache, _logits(params, h, cfg)[:, 0]
