"""pixtral-12b [vlm]: pixtral-ViT frontend (stub) + mistral-nemo backbone.
(port of ``repro/configs/pixtral_12b.py``)

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.
[hf:mistralai/Pixtral-12B-2409; unverified]
"""
from repro_torch.configs import ArchConfig, MoECfg, register

FULL = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    structure="decoder_only",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=131072,
    gated_mlp=True,
    norm="rmsnorm",
    pos_emb="rope",
    frontend="patch",
    n_frontend_positions=1024,
    source="hf:mistralai/Pixtral-12B-2409; unverified",
)

REDUCED = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    structure="decoder_only",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    gated_mlp=True,
    frontend="patch",
    n_frontend_positions=8,
)

register(FULL, REDUCED)


def upcycled(num_experts: int = 32) -> ArchConfig:
    """The sparse-upcycling target for this backbone (decoder => Top-K)."""
    return FULL.with_moe(MoECfg(num_experts=num_experts, router="top_k"))
