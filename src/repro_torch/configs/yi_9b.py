"""yi-9b [dense]: 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
llama-arch GQA. [arXiv:2403.04652; hf]
(port of ``repro/configs/yi_9b.py``)
"""
from repro_torch.configs import ArchConfig, MoECfg, register

FULL = ArchConfig(
    name="yi-9b",
    family="dense",
    structure="decoder_only",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    gated_mlp=True,
    norm="rmsnorm",
    pos_emb="rope",
    source="arXiv:2403.04652; hf",
)

REDUCED = ArchConfig(
    name="yi-9b",
    family="dense",
    structure="decoder_only",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    gated_mlp=True,
)

register(FULL, REDUCED)


def upcycled(num_experts: int = 32) -> ArchConfig:
    return FULL.with_moe(MoECfg(num_experts=num_experts, router="top_k"))
