"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064. GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]
(port of ``repro/configs/qwen2_5_14b.py``)
"""
from repro_torch.configs import ArchConfig, MoECfg, register

FULL = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    structure="decoder_only",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    gated_mlp=True,
    norm="rmsnorm",
    pos_emb="rope",
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)

REDUCED = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    structure="decoder_only",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    qkv_bias=True,
    gated_mlp=True,
)

register(FULL, REDUCED)


def upcycled(num_experts: int = 32) -> ArchConfig:
    return FULL.with_moe(MoECfg(num_experts=num_experts, router="top_k"))
