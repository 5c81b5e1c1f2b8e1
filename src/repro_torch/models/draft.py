"""Draft models for speculative decoding on the serve path (port of
``repro/models/draft.py``).

Upcycling hands the serving stack a free draft: the MoE was initialized
by replicating the dense parent's MLP into every expert
(``core/upcycle.py``), so the dense parent shares tokenizer, embeddings,
attention weights and positions with its upcycled child. Two drafts
come out of the checkpoint the engine already holds, with no training:

``dense``
    Slice expert 0 of every MoE layer back into a plain MLP and drop the
    router. For a freshly upcycled checkpoint (``expert_init="copy"``)
    this IS the dense parent, bit for bit; after fine-tuning it is an
    expert-0 truncation, still a valid draft (exact rejection sampling
    keeps the output distribution whatever the draft; a worse draft
    only accepts less).

``top1``
    Keep the MoE's params and truncate its routing to ``top_k=1``: the
    draft shares every weight with the target and reads fewer experts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.configs import ArchConfig
from repro_torch.models import stack as stk

DRAFT_KINDS = ("none", "dense", "top1")


def dense_parent_params(params, cfg: ArchConfig):
    """Slice the dense parent out of an upcycled MoE's values tree.

    Every MoE layer's ``ffn = {router, experts: {wi[, wg], wo}}``
    becomes ``{k: experts[k][0]}`` (expert 0's copy of the parent MLP);
    the top-level subtrees other than the stacks (embedding, head, final
    norm) are shared by reference. The stacks are cut into layers and
    restacked in the dense parent's segments (``core/upcycle.py``
    ``_unstack``/``_restack``), which stacks their leaves anew.

    Returns (dense_params, dense_cfg) with ``dense_cfg =
    cfg.dense_parent()``.
    """
    if cfg.moe is None:
        raise ValueError("config has no MoE section; nothing to slice")
    from repro_torch.core.upcycle import _restack, _unstack

    dense_cfg = cfg.dense_parent()

    def map_stack(stack_key: str, which: str):
        tdescs = stk.layer_descs(cfg, stack=which)
        ddescs = stk.layer_descs(dense_cfg, stack=which)
        out = []
        for layer, td, dd in zip(_unstack(params[stack_key], tdescs),
                                 tdescs, ddescs):
            new = dict(layer)
            if td.ffn == "moe" and dd.ffn == "dense":
                new["ffn"] = {k: v[0]
                              for k, v in layer["ffn"]["experts"].items()}
            out.append(new)
        return _restack(out, ddescs)

    out = dict(params)
    out["stack"] = map_stack("stack", "decoder")
    if cfg.structure == "encoder_decoder":
        out["encoder"] = map_stack("encoder", "encoder")
    return out, dense_cfg


def top1_cfg(cfg: ArchConfig) -> ArchConfig:
    """The target architecture with routing truncated to top-1."""
    if cfg.moe is None:
        raise ValueError("config has no MoE section; cannot truncate")
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, top_k=1),
        name=cfg.name + "-top1",
    )


def make_draft(params, cfg: ArchConfig, kind: str
               ) -> Tuple[Optional[dict], Optional[ArchConfig]]:
    """(draft_params, draft_cfg) for a ``ServeConfig.draft`` kind:
    ``none`` -> (None, None); ``dense`` -> the expert-0 parent;
    ``top1`` -> the same params under a top-1 routing config."""
    if kind == "none":
        return None, None
    if kind == "dense":
        return dense_parent_params(params, cfg)
    if kind == "top1":
        return params, top1_cfg(cfg)
    raise ValueError(f"unknown draft kind {kind!r}; want one of "
                     f"{DRAFT_KINDS}")
