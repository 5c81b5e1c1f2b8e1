"""Architecture configuration (port of ``repro/configs/__init__.py``).

A copy of ``ArchConfig``, ``MoECfg`` and the registry; the port
registers the architectures it runs (``granite-moe-1b-a400m``,
``vit-b16-upcycled``, ``rwkv6-7b``, ``t5-base-upcycled``,
``whisper-base``).
``get_reduced`` returns the CPU-test-sized config of the same family.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Mapping, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class MoECfg:
    """Mixture-of-Experts configuration (paper §2.1, §3.1)."""

    num_experts: int = 32
    # "expert_choice" | "top_k" | "switch" (top-1)
    router: str = "top_k"
    top_k: int = 2
    capacity_factor: float = 2.0
    # Which MLP layers become MoE: "every_other", "all", "last_half",
    # "none".
    layer_pattern: str = "every_other"
    # Routing group size (paper §A.1.1: max 4096 tokens per group).
    group_size: int = 4096
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 0.0
    # Paper §B.7: renormalize per-token combine weights to sum to 1.
    normalize_combine_weights: bool = False
    # Batch Prioritized Routing for Top-K (paper §B.1).
    bpr: bool = False
    expert_init: str = "copy"
    init_noise_std: float = 0.0
    router_init_std: float = 0.02
    # Expert parallelism ("a2a") needs a device mesh; the single-device
    # port runs the "none" layout, as the reference does without a mesh.
    ep: str = "none"
    ep_budget_factor: float = 2.0


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    """State-space / linear-attention configuration (rwkv6, mamba)."""

    kind: str = "mamba"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    head_size: int = 64


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    structure: str  # decoder_only | encoder_decoder | encoder_only
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 => d_model // n_heads
    qkv_bias: bool = False
    gated_mlp: bool = True
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    pos_emb: str = "rope"  # rope | learned | sinusoidal | none
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    attn_pattern: str = "all"
    frontend: Optional[str] = None
    n_frontend_positions: int = 0
    n_encoder_layers: int = 0
    act: str = "silu"
    sharding_overrides: Mapping[str, Sequence[str]] = dataclasses.field(
        default_factory=dict
    )
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    def with_moe(self, moe: Optional[MoECfg]) -> "ArchConfig":
        return dataclasses.replace(self, moe=moe)

    def dense_parent(self) -> "ArchConfig":
        """The dense architecture this MoE config upcycles from."""
        return dataclasses.replace(
            self, moe=None, name=self.name + "-dense-parent"
        )


_MODULES = ("granite_moe_1b", "vit_upcycled", "rwkv6_7b", "t5_upcycled",
            "whisper_base")

_REGISTRY: dict[str, ArchConfig] = {}
_REDUCED: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig, reduced: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    _REDUCED[cfg.name] = reduced
    return cfg


def _load_all() -> None:
    # Every time, not only while the registry is empty: a config module
    # imported on its own registers its arch first (imports are cached).
    for mod in _MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ArchConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; the port has {sorted(_REGISTRY)} "
            "(other architectures are queued in ROADMAP.md)"
        )
    return _REGISTRY[name]


def get_reduced(name: str) -> ArchConfig:
    get_config(name)
    return _REDUCED[name]
