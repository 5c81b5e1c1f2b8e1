"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16 experts top-2, Mamba+attention 1:7 interleave.
[arXiv:2403.19887; hf]
(port of ``repro/configs/jamba_1_5_large.py``)

Layer layout: period-8 superblock [m m m m a m m m] (attention at index 4 of
each period, per the Jamba paper), MoE on every other layer. 72 layers =
9 superblocks. Natively-MoE: assigned config is the upcycling target.
"""
from repro_torch.configs import ArchConfig, MoECfg, SSMCfg, register

FULL = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    structure="decoder_only",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    gated_mlp=True,
    norm="rmsnorm",
    pos_emb="none",  # jamba uses no explicit positional embedding
    attn_pattern="jamba",
    ssm=SSMCfg(kind="mamba", d_state=16, d_conv=4, expand=2),
    moe=MoECfg(
        num_experts=16, router="top_k", top_k=2, layer_pattern="every_other"
    ),
    source="arXiv:2403.19887; hf",
)

REDUCED = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    structure="decoder_only",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    gated_mlp=True,
    pos_emb="none",
    attn_pattern="jamba",
    ssm=SSMCfg(kind="mamba", d_state=8, d_conv=4, expand=2),
    moe=MoECfg(
        num_experts=4, router="top_k", top_k=2, layer_pattern="every_other",
        group_size=64,
    ),
)

register(FULL, REDUCED)
