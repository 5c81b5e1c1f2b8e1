"""t5-base-upcycled: the paper's language model, T5 1.1 Base upcycled
into "Language Base Sparse 2.00B" (port of
``repro/configs/t5_upcycled.py``; paper §2.2, §A.1.1, Table 1).

T5 1.1 Base: 12 encoder + 12 decoder layers, d_model=768, 12 heads,
d_ff=2048, vocab 32128, GEGLU (the gated gelu MLP of T5 1.1: with it the
parameter counts land on Table 1's 248M dense / 2.00B sparse), RMSNorm,
sinusoidal positions (the relative position bias is omitted, as in the
reference).

Upcycling recipe (paper defaults): every OTHER MLP layer becomes MoE,
starting with the second layer; 32 experts; Expert Choice C=2 in the
encoder, Top-2 with aux loss 0.01 in the decoder (``stack_router_kind``);
router init std 0.02; group size 4096; no combine-weight normalization
(language recipe).

The reduced config is ungated (``gated_mlp=False``); the full one is
GEGLU.
"""
import dataclasses

from repro_torch.configs import ArchConfig, MoECfg, register

T5_BASE_DENSE = ArchConfig(
    name="t5-base",
    family="dense",
    structure="encoder_decoder",
    n_layers=12,
    n_encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=2048,
    vocab_size=32128,
    gated_mlp=True,  # T5 1.1 GEGLU
    act="gelu",
    norm="rmsnorm",
    pos_emb="sinusoidal",
    source="arXiv:1910.10683 (T5 1.1)",
)

LANGUAGE_MOE = MoECfg(
    num_experts=32,
    router="expert_choice",  # encoder; the decoder stack runs top_k
    top_k=2,
    capacity_factor=2.0,
    layer_pattern="every_other",
    group_size=4096,
    aux_loss_weight=0.01,
    normalize_combine_weights=False,
    expert_init="copy",
)

FULL = ArchConfig(
    name="t5-base-upcycled",
    family="dense",
    structure="encoder_decoder",
    n_layers=12,
    n_encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=2048,
    vocab_size=32128,
    gated_mlp=True,  # T5 1.1 GEGLU
    act="gelu",
    norm="rmsnorm",
    pos_emb="sinusoidal",
    moe=LANGUAGE_MOE,
    source="Sparse Upcycling (ICLR 2023) Table 1: Language Base Sparse 2.00B",
)

REDUCED = ArchConfig(
    name="t5-base-upcycled",
    family="dense",
    structure="encoder_decoder",
    n_layers=4,
    n_encoder_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    gated_mlp=False,
    act="gelu",
    norm="rmsnorm",
    pos_emb="sinusoidal",
    moe=MoECfg(
        num_experts=4,
        router="expert_choice",
        capacity_factor=2.0,
        layer_pattern="every_other",
        group_size=64,
        aux_loss_weight=0.01,
    ),
)

register(FULL, REDUCED)


def t5_large_upcycled() -> ArchConfig:
    """T5 Large upcycled: 24+24 L, d_model=1024, 16H, d_ff=2816 (Table 1)."""
    return dataclasses.replace(
        FULL,
        name="t5-large-upcycled",
        n_layers=24,
        n_encoder_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=2816,
    )
