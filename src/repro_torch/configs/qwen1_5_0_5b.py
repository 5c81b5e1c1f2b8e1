"""qwen1.5-0.5b [dense]: 24L d_model=1024 16H (GQA kv=16) d_ff=2816
vocab=151936. QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]
(port of ``repro/configs/qwen1_5_0_5b.py``)
"""
from repro_torch.configs import ArchConfig, MoECfg, register

FULL = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    structure="decoder_only",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    gated_mlp=True,
    norm="rmsnorm",
    pos_emb="rope",
    rope_theta=10000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)

REDUCED = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    structure="decoder_only",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    qkv_bias=True,
    gated_mlp=True,
    tie_embeddings=True,
)

register(FULL, REDUCED)


def upcycled(num_experts: int = 32) -> ArchConfig:
    return FULL.with_moe(MoECfg(num_experts=num_experts, router="top_k"))
