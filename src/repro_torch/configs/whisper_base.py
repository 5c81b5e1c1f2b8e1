"""whisper-base [audio]: 6 + 6 layers, d_model=512, 8 heads, d_ff=2048,
vocab 51865 (port of ``repro/configs/whisper_base.py``).
Encoder-decoder; the conv frontend is a stub (precomputed frame
embeddings through the ``frame`` projection).
[arXiv:2212.04356; unverified]

Encoder-decoder, so the paper's T5 recipe applies when upcycling:
Expert Choice routing in the encoder, Top-2 in the decoder.
"""
from repro_torch.configs import ArchConfig, MoECfg, register

FULL = ArchConfig(
    name="whisper-base",
    family="audio",
    structure="encoder_decoder",
    n_layers=6,
    n_encoder_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    gated_mlp=False,
    act="gelu",
    norm="layernorm",
    pos_emb="sinusoidal",
    frontend="frame",
    source="arXiv:2212.04356; unverified",
)

REDUCED = ArchConfig(
    name="whisper-base",
    family="audio",
    structure="encoder_decoder",
    n_layers=2,
    n_encoder_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    gated_mlp=False,
    act="gelu",
    norm="layernorm",
    pos_emb="sinusoidal",
    frontend="frame",
)

register(FULL, REDUCED)


def upcycled(num_experts: int = 32) -> ArchConfig:
    """whisper-base with MoE layers: Expert Choice in the encoder (the
    decoder stack switches to top-k, ``stack_router_kind``)."""
    return FULL.with_moe(
        MoECfg(num_experts=num_experts, router="expert_choice",
               capacity_factor=2.0)
    )
