"""rwkv6-7b [ssm]: 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536. RWKV-6 "Finch" — data-dependent decay (port of
``repro/configs/rwkv6_7b.py``). [arXiv:2404.05892; hf]

Attention-free: sparse upcycling applies to the channel-mix (MLP)
layers; the time-mix is untouched.
"""
from repro_torch.configs import ArchConfig, MoECfg, SSMCfg, register

FULL = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    structure="decoder_only",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # wkv heads = d_model / head_size
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    gated_mlp=False,  # rwkv channel-mix: squared-relu 2-matrix
    act="sqrelu",
    norm="layernorm",
    pos_emb="none",
    attn_pattern="none",
    ssm=SSMCfg(kind="rwkv6", head_size=64),
    source="arXiv:2404.05892; hf",
)

REDUCED = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    structure="decoder_only",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    gated_mlp=False,
    act="sqrelu",
    norm="layernorm",
    pos_emb="none",
    attn_pattern="none",
    ssm=SSMCfg(kind="rwkv6", head_size=16),
)

register(FULL, REDUCED)


def upcycled(num_experts: int = 32) -> ArchConfig:
    return FULL.with_moe(MoECfg(num_experts=num_experts, router="top_k"))
