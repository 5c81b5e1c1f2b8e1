"""vit-b16-upcycled: the paper's vision model, ViT-B/16 upcycled into
"Vision B/16 Sparse 978M" (port of ``repro/configs/vit_upcycled.py``;
paper §2.2, Table 1).

ViT-B/16: 12 encoder layers, d_model=768, 12 heads, d_ff=3072, gelu MLP,
LayerNorm, learned positional embeddings over 196 patches, global
average pooling head. Vision upcycling recipe: Expert Choice
everywhere, combine-weight normalization on, optimizer state resumed,
MoE in the last half of the layers (6/12, §4.2.2).
"""
from repro_torch.configs import ArchConfig, MoECfg, register

VIT_B16_DENSE = ArchConfig(
    name="vit-b16",
    family="dense",
    structure="encoder_only",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=1000,  # classifier head classes (JFT proxy)
    gated_mlp=False,
    act="gelu",
    norm="layernorm",
    pos_emb="learned",
    frontend="patch",
    n_frontend_positions=196,  # 224/16 ** 2
    source="arXiv:2010.11929 (ViT-B/16)",
)

VISION_MOE = MoECfg(
    num_experts=32,
    router="expert_choice",
    capacity_factor=2.0,
    layer_pattern="last_half",
    group_size=4096,
    aux_loss_weight=0.0,  # Expert Choice needs no load-balance loss
    normalize_combine_weights=True,  # vision recipe (§B.7)
    expert_init="copy",
)

FULL = ArchConfig(
    name="vit-b16-upcycled",
    family="dense",
    structure="encoder_only",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=1000,
    gated_mlp=False,
    act="gelu",
    norm="layernorm",
    pos_emb="learned",
    frontend="patch",
    n_frontend_positions=196,
    moe=VISION_MOE,
    source="Sparse Upcycling (ICLR 2023) Table 1: Vision B/16 Sparse 978M",
)

REDUCED = ArchConfig(
    name="vit-b16-upcycled",
    family="dense",
    structure="encoder_only",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=16,
    gated_mlp=False,
    act="gelu",
    norm="layernorm",
    pos_emb="learned",
    frontend="patch",
    n_frontend_positions=16,
    moe=MoECfg(
        num_experts=4,
        router="expert_choice",
        capacity_factor=2.0,
        layer_pattern="last_half",
        group_size=64,
        aux_loss_weight=0.0,
        normalize_combine_weights=True,
    ),
)

register(FULL, REDUCED)
