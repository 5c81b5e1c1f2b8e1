"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8 (port of
``repro/configs/granite_moe_1b.py``).
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs import ArchConfig, MoECfg, register

FULL = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    structure="decoder_only",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    gated_mlp=True,
    norm="rmsnorm",
    pos_emb="rope",
    tie_embeddings=True,
    moe=MoECfg(num_experts=32, router="top_k", top_k=8, layer_pattern="all"),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)

REDUCED = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    structure="decoder_only",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab_size=259,
    gated_mlp=True,
    tie_embeddings=True,
    moe=MoECfg(
        num_experts=8, router="top_k", top_k=4, layer_pattern="all",
        group_size=64,
    ),
)

register(FULL, REDUCED)
