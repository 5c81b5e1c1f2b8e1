"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]
(port of ``repro/configs/grok_1_314b.py``)

Natively-MoE arch: the assigned config IS the sparse-upcycling target; the
dense parent (same dims, no MoE) is what a practitioner would upcycle from.
"""
from repro_torch.configs import ArchConfig, MoECfg, register

FULL = ArchConfig(
    name="grok-1-314b",
    family="moe",
    structure="decoder_only",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    gated_mlp=True,
    norm="rmsnorm",
    pos_emb="rope",
    moe=MoECfg(num_experts=8, router="top_k", top_k=2, layer_pattern="all"),
    source="hf:xai-org/grok-1; unverified",
)

REDUCED = ArchConfig(
    name="grok-1-314b",
    family="moe",
    structure="decoder_only",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    gated_mlp=True,
    moe=MoECfg(
        num_experts=4, router="top_k", top_k=2, layer_pattern="all",
        group_size=64,
    ),
)

register(FULL, REDUCED)
