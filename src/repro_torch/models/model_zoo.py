"""Top-level model entry points for decoder-only, encoder-decoder and
encoder-only stacks (port of the training and serving subsets of
``repro/models/model_zoo.py``): ``init_params``, ``forward_train``,
``loss_fn``, the static engine's ``init_serve_cache``, ``prefill`` and
``decode_step``, and the paged engine's ``init_paged_serve_cache``,
``paged_prefill`` (prefill-on-join), ``paged_decode_step``,
``paged_mixed_step`` and the speculative ``paged_verify_step``
(decoder-only, as the reference's).

Batch formats
  decoder_only    : ``{"tokens": (B, S), "targets": (B, S)}`` with -1
                    marking masked-out targets; a ``patch`` frontend
                    (pixtral) adds ``"patch_embeds": (B, P, d)``, which
                    replace the embeddings of the first P positions;
  encoder_decoder : ``{"enc_tokens": (B, Se)`` or ``"frames": (B, Se,
                    d), "dec_tokens": (B, Sd), "targets": (B, Sd)}``
                    (T5, whisper);
  encoder_only    : ``{"patch_embeds": (B, P, d), "labels": (B,)}``
                    (ViT).

``ApplyCfg`` carries the reference's training knobs: remat of the
stack (``models/stack.py``), the chunked cross-entropy (``ce_chunk``)
and the compute dtype (``compute_dtype="bfloat16"``: every entry point
computes with a bfloat16 copy of the floating parameters, gradients
reaching the float32 masters through the cast, as the reference's
``_cast_params``), and the query-head padding ``pad_heads_multiple``
(``attention.pad_heads``; output exactly preserved). The training entry
points take a ``ShardCtx`` (``ctx``), which reaches the MoE layers
(expert parallelism, ``core/ep.py``). So do the six serving entry
points: under the ctx of ``sharding.serve_layout`` each rank runs its
blocks of the heads, KV heads, experts and ``mlp`` over ``model`` on
its caches' blocks, and the logits come back whole on every rank.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
    sinusoidal,
    vocab_logits,
)


COMPUTE_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class ApplyCfg:
    """Runtime knobs. ``moe_impl``/``attn_impl``/``mixer_impl`` (the
    RWKV WKV) in ``auto|cuda|eager``: ``resolve(device)`` pins "auto" to
    the CUDA kernels on a CUDA device (on the meta device: their
    shape-only route, ``kernels/ops.py``) and to the plain PyTorch
    versions elsewhere. The reference's "pallas" is the port's "cuda"; its "xla"
    and "ref" are the port's "eager".

    ``remat``: none | full | dots | moe (``stack.stack_apply``).
    ``compute_dtype``: float32 | bfloat16, the dtype of the parameters'
    compute copy and of the activations (``cdtype``); logits and losses
    stay float32. ``ce_chunk``: 0 computes the whole (B, S, V) logits;
    n > 0 the cross-entropy over sequence chunks of n (``_chunked_ce``),
    whose logits the backward recomputes. ``pad_heads_multiple``: zero
    query heads padded up to a multiple of this in every attention
    layer (0: none)."""

    dispatch: str = "gather"  # moe dispatch: gather | einsum | sorted
    moe_impl: str = "auto"
    attn_impl: str = "auto"
    mixer_impl: str = "auto"
    remat: str = "none"
    compute_dtype: str = "float32"
    ce_chunk: int = 0
    pad_heads_multiple: int = 0

    @property
    def cdtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.compute_dtype == "bfloat16"
                else torch.float32)

    def resolve(self, device) -> "ApplyCfg":
        impls = ("moe_impl", "attn_impl", "mixer_impl")
        for name in impls:
            if getattr(self, name) not in IMPLEMENTATIONS:
                raise ValueError(f"unknown implementation "
                                 f"{getattr(self, name)!r} {IMPLEMENTATIONS}")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype "
                             f"{self.compute_dtype!r} {COMPUTE_DTYPES}")
        pin = ("cuda" if torch.device(device).type in ("cuda", "meta")
               else "eager")
        return dataclasses.replace(self, **{
            name: pin for name in impls if getattr(self, name) == "auto"})


def _check_structure(cfg: ArchConfig, *ok: str) -> None:
    if cfg.structure not in ok:
        raise ValueError(
            f"{cfg.name} is {cfg.structure}: this entry point runs "
            f"{' and '.join(ok)} models"
        )


def init_params(gen, cfg: ArchConfig, *, dtype=torch.float32, device=None):
    """Random parameters with the JAX key paths and layouts.

    ``gen`` is a ``torch.Generator`` on ``device`` or an int seed.
    ``device`` defaults to "cuda" and raises without a card. An
    encoder-decoder model has the reference's keys ``embed``,
    [``frontend``], ``encoder``, ``enc_final_norm``, ``stack``,
    ``final_norm`` and ``head``."""
    device = resolve_device(device)
    if isinstance(gen, int):
        gen = torch.Generator(device=device).manual_seed(gen)
    kw = dict(dtype=dtype, device=device)
    if cfg.structure == "encoder_only":
        return {
            "frontend": frontend_init(gen, cfg, **kw),
            "pos": pm.normal(gen, (cfg.n_frontend_positions, cfg.d_model),
                             "pos embed", **kw),
            "stack": stk.stack_init(gen, cfg, stk.layer_descs(cfg), **kw),
            "final_norm": norm_init(cfg, device=device),
            "head": {"w": pm.dense(gen, (cfg.d_model, cfg.vocab_size),
                                   "embed vocab", **kw)},
        }
    p = {"embed": embed_init(gen, cfg, **kw)}
    if cfg.frontend is not None:
        p["frontend"] = frontend_init(gen, cfg, **kw)
    if cfg.structure == "encoder_decoder":
        p["encoder"] = stk.stack_init(
            gen, cfg, stk.layer_descs(cfg, stack="encoder"), **kw)
        p["enc_final_norm"] = norm_init(cfg, device=device)
    p["stack"] = stk.stack_init(gen, cfg, stk.layer_descs(cfg), **kw)
    p["final_norm"] = norm_init(cfg, device=device)
    p["head"] = head_init(gen, cfg, **kw)
    return p


def param_axes(cfg: ArchConfig):
    """The logical-axes tree of ``init_params(cfg)`` (the reference's
    ``pm.split(...)[1]``): the parameters built on the meta device, each
    leaf's recorded axes read off."""
    params = init_params(None, cfg, device="meta")
    return pm.tree_map(pm.axes_of, params)


def _cast_params(params, dtype):
    """Mixed precision: compute with a ``dtype`` copy of the floating
    leaves (autograd carries the gradients through the cast back to the
    masters). A leaf already in ``dtype`` is used as it is, uncopied."""
    return pm.tree_map(
        lambda p: p.to(dtype) if p.is_floating_point() else p, params)


def _embed_decoder_input(params, batch, cfg: ArchConfig, ac: ApplyCfg,
                         ctx=None):
    """The decoder's input: ``tokens`` (decoder-only) or ``dec_tokens``
    (encoder-decoder) embedded at positions 0..S-1, in the compute
    dtype. A decoder with a frontend whose batch carries
    ``patch_embeds`` (B, P, d) takes the frontend's projection of them
    in place of the first P embeddings."""
    tokens = (batch["tokens"] if "tokens" in batch
              else batch["dec_tokens"]).long()
    x = embed_apply(params["embed"], tokens, cfg,
                    positions=torch.arange(tokens.shape[1],
                                           device=tokens.device), ctx=ctx)
    if cfg.frontend is not None and "patch_embeds" in batch:
        front = frontend_apply(params["frontend"], batch["patch_embeds"],
                               cfg).to(x.dtype)
        x = torch.cat([front, x[:, front.shape[1]:]], dim=1)
    return x.to(ac.cdtype)


def _encode(params, batch, cfg: ArchConfig, ac: ApplyCfg, ctx=None):
    """The encoder stack of an encoder-decoder model: the token
    embedding with sinusoidal positions, or the ``frame`` frontend's
    projection plus sinusoidal positions; bidirectional, its MoE layers
    routed by ``stack_router_kind(cfg, stack="encoder")`` (Expert
    Choice); then ``enc_final_norm``. Returns (enc (B, Se, d),
    metrics)."""
    if cfg.frontend == "frame":
        x = frontend_apply(params["frontend"], batch["frames"], cfg)
        pos = torch.arange(x.shape[1], device=x.device)
        x = x + sinusoidal(pos, cfg.d_model).to(x.dtype)
    else:
        tokens = batch["enc_tokens"].long()
        x = embed_apply(params["embed"], tokens, cfg,
                        positions=torch.arange(tokens.shape[1],
                                               device=tokens.device),
                        ctx=ctx)
    x, mets, _ = stk.stack_apply(
        params["encoder"], x.to(ac.cdtype), cfg,
        stk.layer_descs(cfg, stack="encoder"), causal=False,
        router_kind=stk.stack_router_kind(cfg, stack="encoder"),
        dispatch=ac.dispatch, moe_impl=ac.moe_impl, attn_impl=ac.attn_impl,
        mixer_impl=ac.mixer_impl, remat=ac.remat,
        pad_heads_multiple=ac.pad_heads_multiple, ctx=ctx,
    )
    return norm_apply(params["enc_final_norm"], x, cfg), mets


def forward_train(params, batch, cfg: ArchConfig, *,
                  ac: ApplyCfg = ApplyCfg(), return_hidden: bool = False,
                  ctx=None):
    """The training forward, through the flash-attention and expert-FFN
    kernels (and their backward kernels under autograd) on a CUDA
    device, in ``ac.compute_dtype`` under ``ac.remat``. Decoder-only:
    causal LM over ``batch["tokens"] (B, S)`` at positions 0..S-1,
    logits (B, S, V); an rwkv6 stack runs forward only through the WKV
    kernel (it raises under autograd: pass ``mixer_impl="eager"`` to
    differentiate). Encoder-decoder: the encoder (:func:`_encode`), then
    the causal decoder over ``batch["dec_tokens"]`` with
    cross-attention onto the encoder states, logits (B, Sd, V); the
    encoder's metrics are added to the decoder's. Encoder-only (ViT):
    the patch frontend plus learned positions, the bidirectional stack
    (Expert Choice in its MoE layers), the final norm, global average
    pooling and the class head, logits (B, V). Returns (logits float32,
    metrics); with ``return_hidden`` (not encoder-only) the final-norm
    hidden states (B, S, d) in the compute dtype instead of the
    logits. ``ctx``: a ``ShardCtx`` (the batch holds this rank's rows,
    the params the blocks the step computes with,
    ``sharding/comm.params_for_compute``): the layers run tensor
    parallel on their ``model`` blocks, and a head holding the rank's
    block of ``vocab`` gives that block of the logits (:func:`loss_fn`
    takes the cross-entropy over the blocks)."""
    params = _cast_params(params, ac.cdtype)
    if cfg.structure == "encoder_only":
        pe = batch["patch_embeds"]
        ac = ac.resolve(pe.device)
        x = frontend_apply(params["frontend"], pe, cfg)
        x = (x + params["pos"][None]).to(ac.cdtype)
        x, mets, _ = stk.stack_apply(
            params["stack"], x, cfg, stk.layer_descs(cfg), causal=False,
            router_kind=stk.stack_router_kind(cfg, stack="encoder"),
            dispatch=ac.dispatch, moe_impl=ac.moe_impl,
            attn_impl=ac.attn_impl, remat=ac.remat,
            pad_heads_multiple=ac.pad_heads_multiple, ctx=ctx,
        )
        x = norm_apply(params["final_norm"], x, cfg)
        pooled = x.mean(dim=1)  # global average pooling (paper §2.2)
        return vocab_logits(pooled, params["head"]["w"], cfg,
                            ctx).float(), mets
    x = _embed_decoder_input(params, batch, cfg, ac, ctx)
    ac = ac.resolve(x.device)
    enc, enc_mets = None, None
    if cfg.structure == "encoder_decoder":
        enc, enc_mets = _encode(params, batch, cfg, ac, ctx)
    x, mets, _ = _stack(params, x, cfg, ac, enc=enc, remat=ac.remat,
                        ctx=ctx)
    if enc_mets is not None:
        mets = {k: v + enc_mets[k] for k, v in mets.items()}
    x = norm_apply(params["final_norm"], x, cfg)
    if return_hidden:
        return x, mets
    return head_apply(params.get("head", {}), x, params["embed"],
                      cfg, ctx).float(), mets


def loss_fn(params, batch, cfg: ArchConfig, *, ac: ApplyCfg = ApplyCfg(),
            ctx=None):
    """Returns (loss, metrics): mean cross-entropy over the valid
    targets (``targets >= 0``), or over the images' ``labels`` for an
    encoder-only model, plus the weighted MoE aux and z losses. With
    ``ac.ce_chunk`` (not encoder-only) the cross-entropy runs over
    sequence chunks (:func:`_chunked_ce`) and the whole logits are
    never held."""
    if cfg.structure != "encoder_only" and ac.ce_chunk:
        hidden, mets = forward_train(params, batch, cfg, ac=ac,
                                     return_hidden=True, ctx=ctx)
        w = (params["embed"]["tokens"].T if cfg.tie_embeddings
             else params["head"]["w"]).to(ac.cdtype)
        targets = batch["targets"].long()
        ce = (_chunked_ce(hidden, w, targets, ac.ce_chunk, cfg, ctx)
              if ctx is not None and w.shape[-1] != cfg.vocab_size
              else _chunked_ce(hidden, w, targets, ac.ce_chunk))
        loss = ce + mets["aux_loss"] + mets["z_loss"]
        out = dict(mets)
        out.update(loss=loss, ce=ce)
        return loss, out
    logits, mets = forward_train(params, batch, cfg, ac=ac, ctx=ctx)
    if cfg.structure == "encoder_only":
        ce = _token_ce(logits, batch["labels"].long(), cfg, ctx).mean()
    else:
        targets = batch["targets"].long()
        valid = targets >= 0
        ce_tok = _token_ce(logits, targets.clamp(min=0), cfg, ctx)
        denom = torch.clamp(valid.sum(), min=1)
        ce = torch.where(valid, ce_tok,
                         torch.zeros_like(ce_tok)).sum() / denom
    loss = ce + mets["aux_loss"] + mets["z_loss"]
    out = dict(mets)
    out.update(loss=loss, ce=ce)
    return loss, out


def _token_ce(logits, targets, cfg: ArchConfig, ctx=None):
    """Each row's cross-entropy at its target (in range) from float32
    logits (..., V). Logits holding the rank's block of the vocabulary
    (vocab-parallel, ``head_apply`` under ``ctx``): the max, the sum of
    exponentials and the target's logit each taken over the blocks
    (all-reduced over ``model``)."""
    V = logits.shape[-1]
    if ctx is None or V == cfg.vocab_size:
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, targets[..., None])[..., 0]
    from repro_torch.sharding import comm

    mx = comm.max_over_model(logits.max(-1).values, ctx)
    se = comm.reduce_from_model(
        torch.exp(logits - mx[..., None]).sum(-1), ctx)
    local = targets - ctx.tp_rank * V
    mine = (local >= 0) & (local < V)
    tl = torch.gather(logits, -1, torch.where(
        mine, local, torch.zeros_like(local))[..., None])[..., 0]
    tl = comm.reduce_from_model(
        torch.where(mine, tl, torch.zeros_like(tl)), ctx)
    return torch.log(se) + mx - tl


def _ce_chunk(x, w, targets, cfg=None, ctx=None):
    """(summed CE, valid count) of one chunk: logits (B, c, V) in float32
    from x and w's values (bfloat16 products are exact in float32); the
    rank's vocabulary block of them where ``w`` holds it."""
    logits = (x.float() @ w.float() if ctx is None
              else vocab_logits(x.float(), w.float(), cfg, ctx))
    valid = targets >= 0
    ce_tok = _token_ce(logits, targets.clamp(min=0), cfg, ctx)
    return (torch.where(valid, ce_tok, torch.zeros_like(ce_tok)).sum(),
            valid.sum())


def _chunked_ce(hidden, w, targets, chunk: int, cfg=None, ctx=None):
    """Cross-entropy over sequence chunks (port of the reference's
    ``_chunked_ce``). hidden: (B, S, d); w: (d, V); targets (B, S) with
    -1 = masked. The sequence is padded to a multiple of
    ``min(chunk, S)`` with masked targets; each chunk computes its
    logits and reduces them to a summed CE under
    ``torch.utils.checkpoint``, so the backward recomputes a chunk's
    logits and the (B, S, V) logits are never held."""
    B, S, d = hidden.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    ce_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for lo in range(0, S + pad, chunk):
        s, k = checkpoint(_ce_chunk, hidden[:, lo:lo + chunk], w,
                          targets[:, lo:lo + chunk], cfg, ctx,
                          use_reentrant=False)
        ce_sum = ce_sum + s
        n = n + k
    return ce_sum / torch.clamp(n, min=1)


def init_paged_serve_cache(cfg: ArchConfig, num_blocks: int,
                           block_size: int, *, dtype=torch.bfloat16,
                           device=None):
    """Per-layer KV block pools addressed by shared per-slot block
    tables. ``device`` defaults to "cuda" and raises without a card.
    Decoder-only and attention-only, as the reference's: an
    encoder-decoder model carries a dense encoder cache (serve it
    through ``prefill`` and ``decode_step``), mamba and rwkv6 layers
    keep per-slot states with no sequence axis to page (serve them
    through the static engine)."""
    _check_structure(cfg, "decoder_only")
    descs = stk.layer_descs(cfg)
    if any(d.mixer != "attn" for d in descs):
        raise ValueError(
            "paged serving requires an attention-only decoder stack "
            f"(got {sorted({d.mixer for d in descs})} in {cfg.name}): it "
            "supports attention mixers only; serve it through the static "
            "engine, ServeConfig(paged=False)")
    device = resolve_device(device)
    return {"stack": stk.stack_paged_cache_init(
        cfg, descs, num_blocks, block_size, dtype=dtype, device=device,
    )}


def _stack(params, x, cfg, ac: ApplyCfg, **kw):
    return stk.stack_apply(
        params["stack"], x, cfg, stk.layer_descs(cfg),
        router_kind=stk.stack_router_kind(cfg, stack="decoder"),
        dispatch=ac.dispatch, moe_impl=ac.moe_impl, attn_impl=ac.attn_impl,
        mixer_impl=ac.mixer_impl, pad_heads_multiple=ac.pad_heads_multiple,
        **kw,
    )


def _serving(cfg: ArchConfig, ctx):
    """The ctx a serving entry point runs under: None for one process;
    a ctx with process groups must come from ``sharding.serve_layout``
    (a ``ServePlan``)."""
    if ctx is None or not ctx.groups:
        return ctx
    from repro_torch.sharding import _check_serving_stack

    _check_serving_stack(cfg)
    if ctx.serve is None:
        raise ValueError(
            "serving under a mesh runs with the ctx of "
            "sharding.serve_layout (its ServePlan places the rows and "
            "caches)")
    return ctx


def _logits(params, h, cfg, ctx=None, rows: bool = False):
    """float32 logits of the final-normed ``h``, whole on every rank
    under a serving ctx: a vocab-parallel head's blocks gathered over
    ``model``, and with ``rows`` the static batch's row blocks over its
    data axes (``ServePlan.batch_axes``)."""
    h = norm_apply(params["final_norm"], h, cfg)
    logits = head_apply(params.get("head", {}), h, params["embed"],
                        cfg, ctx).float()
    if ctx is None or not ctx.groups:
        return logits
    from repro_torch.sharding import comm

    if logits.shape[-1] != cfg.vocab_size:
        logits = comm.gather_replicated(logits, -1, ctx,
                                        "logits_all_gather")
    if rows:
        logits = comm.gather_rows(logits, ctx, ctx.serve.batch_axes,
                                  "logits_all_gather")
    return logits


def init_serve_cache(cfg: ArchConfig, batch: int, max_len: int, *,
                     dtype=torch.bfloat16, device=None, enc_len: int = 0):
    """The static engine's caches: a dense (B, max_len, Kh, dh) KV cache
    per attention layer, the ``conv`` window and ``ssm`` state per mamba
    layer (``ssm`` always float32), the time-mix ``x_prev``/``wkv`` and
    channel-mix ``x_prev`` states per rwkv6 layer (``wkv`` always
    float32); an
    encoder-decoder model adds ``enc`` (B, enc_len, d), which ``prefill``
    replaces with the encoder's states. ``device`` defaults to "cuda"
    and raises without a card."""
    _check_structure(cfg, "decoder_only", "encoder_decoder")
    device = resolve_device(device)
    cache = {"stack": stk.stack_cache_init(
        cfg, stk.layer_descs(cfg), batch, max_len, dtype=dtype,
        device=device,
    )}
    if cfg.structure == "encoder_decoder":
        cache["enc"] = torch.zeros((batch, enc_len, cfg.d_model),
                                   dtype=dtype, device=device)
    return cache


def serve_cache_axes(cfg: ArchConfig):
    """The logical axes of :func:`init_serve_cache`'s caches."""
    axes = {"stack": stk.stack_cache_axes(stk.layer_descs(cfg))}
    if cfg.structure == "encoder_decoder":
        axes["enc"] = "batch seq embed"
    return axes


def prefill(params, batch, cache, cfg: ArchConfig, *,
            ac: ApplyCfg = ApplyCfg(), ctx=None):
    """Run the full prompts ``batch["tokens"] (B, S)`` from an empty
    cache, writing it in place. An encoder-decoder model first encodes
    ``batch["enc_tokens"]`` (or ``"frames"``) and stores the states in
    ``cache["enc"]`` (in the cache's dtype, as the reference does; this
    prefill's cross-attention reads them unrounded); its decoder prompt
    is ``batch["dec_tokens"]``. A ``patch`` frontend's
    ``batch["patch_embeds"]`` replace the first positions' embeddings,
    as in training. Returns (cache, logits (B, 1, V) float32 at the last
    position).

    ``ctx``: the ctx of ``sharding.serve_layout`` (or None). The batch
    then holds this rank's block of the rows (``ServePlan.batch_axes``),
    ``params`` and ``cache`` the rank's blocks, and the logits come back
    for every row of the global batch."""
    _check_structure(cfg, "decoder_only", "encoder_decoder")
    ctx = _serving(cfg, ctx)
    params = _cast_params(params, ac.cdtype)
    x = _embed_decoder_input(params, batch, cfg, ac, ctx)
    ac = ac.resolve(x.device)
    enc = None
    if cfg.structure == "encoder_decoder":
        enc, _ = _encode(params, batch, cfg, ac, ctx)
        cache["enc"] = enc.to(cache["enc"].dtype)
    x, _, cache["stack"] = _stack(params, x, cfg, ac, enc=enc,
                                  cache=cache["stack"], cache_index=0,
                                  mode="prefill", ctx=ctx)
    return cache, _logits(params, x[:, -1:], cfg, ctx, rows=True)


def decode_step(params, tokens, cache, cache_index: int, cfg: ArchConfig,
                *, ac: ApplyCfg = ApplyCfg(), ctx=None):
    """One autoregressive step of the static engine. tokens: (B, 1) at
    position ``cache_index`` (an int, shared by the batch); an
    encoder-decoder model's cross-attention reads ``cache["enc"]``.
    Updates the cache in place; returns (cache, logits (B, 1, V)
    float32). ``ctx``: as :func:`prefill`'s (tokens the rank's rows,
    logits every row's)."""
    _check_structure(cfg, "decoder_only", "encoder_decoder")
    ctx = _serving(cfg, ctx)
    tokens = tokens.long()
    ac = ac.resolve(tokens.device)
    params = _cast_params(params, ac.cdtype)
    index = int(cache_index)
    x = embed_apply(params["embed"], tokens, cfg,
                    positions=torch.arange(index, index + 1,
                                           device=tokens.device),
                    ctx=ctx).to(ac.cdtype)
    enc = (cache["enc"].to(x.dtype) if cfg.structure == "encoder_decoder"
           else None)
    x, _, cache["stack"] = _stack(params, x, cfg, ac, enc=enc,
                                  cache=cache["stack"], cache_index=index,
                                  mode="decode", ctx=ctx)
    return cache, _logits(params, x, cfg, ctx, rows=True)


def paged_prefill(params, tokens, cache, block_table, length,
                  cfg: ArchConfig, *, ac: ApplyCfg = ApplyCfg(), ctx=None):
    """Prefill ONE request into its freshly allocated KV blocks
    (continuous batching's prefill-on-join).

    tokens: (1, Sp) right-padded prompt, Sp a multiple of the block size
    (the engine buckets prompt lengths: the padded tail's k/v land in
    the slot's own blocks and stay masked by ``length`` until decode
    overwrites them); block_table: (1, nb); length: the true prompt
    length (an int). Attention runs over the local fresh k/v through
    ``ops.flash_attention``. Updates the pools in place; returns (cache,
    logits (1, 1, V)) at the TRUE last prompt position ``length - 1``,
    not the padded one. ``ctx``: the ctx of ``sharding.serve_layout``
    (the rows replicated over the data axes, the pools the rank's KV
    heads), or None."""
    ctx = _serving(cfg, ctx)
    tokens = tokens.long()
    ac = ac.resolve(tokens.device)
    params = _cast_params(params, ac.cdtype)
    x = _embed_decoder_input(params, {"tokens": tokens}, cfg, ac, ctx)
    x, _, cache["stack"] = _stack(
        params, x, cfg, ac, cache=cache["stack"],
        cache_index=torch.zeros((1,), dtype=torch.int32,
                                device=tokens.device),
        block_tables=block_table, ctx=ctx,
    )
    n = int(length)
    return cache, _logits(params, x[:, n - 1:n], cfg, ctx)


def paged_decode_step(params, tokens, cache, block_tables, lengths,
                      cfg: ArchConfig, *, ac: ApplyCfg = ApplyCfg(),
                      ctx=None):
    """One continuous-batching decode step over the slot batch.

    tokens: (B, 1); block_tables: (B, nb); lengths: (B,) tokens already
    cached per slot (0 = free slot: masked out of routing, write to the
    trash block). Updates the pools in place; returns (cache, logits
    (B, 1, V)). ``ctx``: as :func:`paged_prefill`'s."""
    ctx = _serving(cfg, ctx)
    ac = ac.resolve(tokens.device)
    params = _cast_params(params, ac.cdtype)
    live = lengths > 0
    x = embed_apply(params["embed"], tokens, cfg,
                    positions=lengths[:, None], ctx=ctx).to(ac.cdtype)
    x, _, cache["stack"] = _stack(
        params, x, cfg, ac, cache=cache["stack"], cache_index=lengths,
        block_tables=block_tables, token_mask=live[:, None], ctx=ctx,
    )
    return cache, _logits(params, x, cfg, ctx)


def paged_mixed_step(params, dec_tokens, chunk_tokens, cache, dec_tables,
                     dec_lengths, chunk_tables, chunk_starts, chunk_lens,
                     cfg: ArchConfig, *, ac: ApplyCfg = ApplyCfg(),
                     ctx=None):
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
    last valid row. ``ctx``: as :func:`paged_prefill`'s."""
    ctx = _serving(cfg, ctx)
    ac = ac.resolve(dec_tokens.device)
    params = _cast_params(params, ac.cdtype)
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
                    positions=positions[:, None], ctx=ctx).to(ac.cdtype)
    x, _, cache["stack"] = _stack(
        params, x, cfg, ac, cache=cache["stack"], cache_index=positions,
        block_tables=row_tables, token_mask=token_mask,
        mixed=MixedMeta(num_decode=B, num_chunks=NC, chunk_tokens=C,
                        chunk_lens=chunk_lens), ctx=ctx,
    )
    d = x.shape[-1]
    last = torch.clamp(chunk_lens - 1, 0, C - 1).long()
    xc = x[B:, 0].reshape(NC, C, d)[torch.arange(NC, device=dev), last]
    h = torch.cat([x[:B, 0], xc])[:, None]
    return cache, _logits(params, h, cfg, ctx)[:, 0]


def paged_verify_step(params, verify_tokens, chunk_tokens, cache,
                      verify_tables, verify_starts, verify_lens,
                      chunk_tables, chunk_starts, chunk_lens,
                      cfg: ArchConfig, *, ac: ApplyCfg = ApplyCfg(),
                      ctx=None):
    """One fused speculative-verify + chunked-prefill step: the target
    scores B verify lanes of K1 = k + 1 positions (a slot's pending token
    and its k drafts) AND the pending prefill chunks in one forward.

    verify_tokens: (B, K1) right-padded; verify_tables: (B, nb) (zeroed
    for slots not verifying); verify_starts: (B,) tokens already cached
    (the pending token's write position); verify_lens: (B,) valid rows
    a lane, 1 + k_eff (0 = idle). chunk_*: as in
    :func:`paged_mixed_step`. The R = B*K1 + NC*C rows share the one
    paged k/v scatter (in place); verify rows read through the paged
    prefill kernel (row j attends positions <= start + j), dead rows
    write to the trash block and are masked out of routing.

    Returns ``(cache, logits (B*K1 + NC, V))``: rows [:B*K1] the target
    logits at EVERY verify position (row b*K1 + j scores the token after
    verify_tokens[b, j]), rows [B*K1:] each chunk lane's last valid
    row. ``ctx``: as :func:`paged_prefill`'s."""
    ctx = _serving(cfg, ctx)
    ac = ac.resolve(verify_tokens.device)
    params = _cast_params(params, ac.cdtype)
    dev = verify_tokens.device
    B, K1 = verify_tokens.shape
    NC, C = chunk_tokens.shape
    i32 = torch.int32
    verify_starts = verify_starts.to(i32)
    verify_lens = verify_lens.to(i32)
    chunk_starts = chunk_starts.to(i32)
    chunk_lens = chunk_lens.to(i32)
    ark = torch.arange(K1, device=dev, dtype=i32)
    arc = torch.arange(C, device=dev, dtype=i32)
    ver_live = ark[None, :] < verify_lens[:, None]
    chunk_live = arc[None, :] < chunk_lens[:, None]
    tokens = torch.cat([verify_tokens.reshape(B * K1),
                        chunk_tokens.reshape(NC * C)])[:, None].long()
    positions = torch.cat([
        (verify_starts[:, None] + ark[None, :]).reshape(B * K1),
        (chunk_starts[:, None] + arc[None, :]).reshape(NC * C),
    ])
    row_tables = torch.cat([
        torch.repeat_interleave(verify_tables, K1, dim=0),
        torch.repeat_interleave(chunk_tables, C, dim=0),
    ]).to(i32)
    token_mask = torch.cat([ver_live.reshape(B * K1),
                            chunk_live.reshape(NC * C)])[:, None]
    x = embed_apply(params["embed"], tokens, cfg,
                    positions=positions[:, None], ctx=ctx).to(ac.cdtype)
    x, _, cache["stack"] = _stack(
        params, x, cfg, ac, cache=cache["stack"], cache_index=positions,
        block_tables=row_tables, token_mask=token_mask,
        mixed=MixedMeta(num_decode=0, num_chunks=NC, chunk_tokens=C,
                        chunk_lens=chunk_lens, num_verify=B,
                        verify_tokens=K1, verify_lens=verify_lens),
        ctx=ctx,
    )
    d = x.shape[-1]
    last = torch.clamp(chunk_lens - 1, 0, C - 1).long()
    xc = x[B * K1:, 0].reshape(NC, C, d)[torch.arange(NC, device=dev),
                                         last]
    h = torch.cat([x[:B * K1, 0], xc])[:, None]
    return cache, _logits(params, h, cfg, ctx)[:, 0]
