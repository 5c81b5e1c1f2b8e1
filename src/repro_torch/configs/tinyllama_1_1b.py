"""tinyllama-1.1b [dense]: 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000. llama2-arch small. [arXiv:2401.02385; hf]
(port of ``repro/configs/tinyllama_1_1b.py``)
"""
from repro_torch.configs import ArchConfig, MoECfg, register

FULL = ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    structure="decoder_only",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    gated_mlp=True,
    norm="rmsnorm",
    pos_emb="rope",
    rope_theta=10000.0,
    source="arXiv:2401.02385; hf",
)

REDUCED = ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    structure="decoder_only",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    gated_mlp=True,
    rope_theta=10000.0,
)

register(FULL, REDUCED)


def upcycled(num_experts: int = 32) -> ArchConfig:
    return FULL.with_moe(MoECfg(num_experts=num_experts, router="top_k"))
