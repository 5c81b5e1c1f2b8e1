"""Architecture configuration (port of ``repro/configs/__init__.py``).

A copy of ``ArchConfig``, ``MoECfg``, the shape grid and the registry;
the port registers every architecture of the reference: its ten
assigned ones (``assigned_archs``) and the paper's ``t5-base-upcycled``
and ``vit-b16-upcycled``. ``get_reduced`` returns the CPU-test-sized
config of the same family.
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
    # Expert parallelism ("a2a", core/ep.py) runs on a mesh with a
    # ``model`` axis that divides the experts (a ShardCtx); without one
    # the sorted dispatch runs the "none" layout, as in the reference.
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

    @property
    def attention_free(self) -> bool:
        return self.attn_pattern == "none"

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context (500k) decode is supported (SSM/hybrid)."""
        return self.attn_pattern in ("none", "jamba")

    def with_moe(self, moe: Optional[MoECfg]) -> "ArchConfig":
        return dataclasses.replace(self, moe=moe)

    def dense_parent(self) -> "ArchConfig":
        """The dense architecture this MoE config upcycles from."""
        return dataclasses.replace(
            self, moe=None, name=self.name + "-dense-parent"
        )


# ---------------------------------------------------------------------------
# Shape grid (the 4 shapes shared by the 10 assigned LM-family archs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Mapping[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeCfg) -> tuple[bool, str]:
    """Whether a (arch, shape) cell is runnable; else (False, reason)."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "pure full-attention arch: no sub-quadratic 500k path"
    if arch.structure == "encoder_only" and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# Module name -> arch id of the assigned architectures, in assignment
# order.
_ASSIGNED = {
    "pixtral_12b": "pixtral-12b",
    "qwen2_5_14b": "qwen2.5-14b",
    "tinyllama_1_1b": "tinyllama-1.1b",
    "qwen1_5_0_5b": "qwen1.5-0.5b",
    "yi_9b": "yi-9b",
    "grok_1_314b": "grok-1-314b",
    "granite_moe_1b": "granite-moe-1b-a400m",
    "whisper_base": "whisper-base",
    "rwkv6_7b": "rwkv6-7b",
    "jamba_1_5_large": "jamba-1.5-large-398b",
}
_PAPER = ("t5_upcycled", "vit_upcycled")
_MODULES = (*_ASSIGNED, *_PAPER)

_REGISTRY: dict[str, ArchConfig] = {}
_REDUCED: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig, reduced: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    _REDUCED[cfg.name] = reduced
    return cfg


def _load_all() -> None:
    # Every time, not only while the registry is empty: a config module
    # imported on its own registers its arch first. The imports after
    # the first are lookups in sys.modules.
    for mod in _MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ArchConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_reduced(name: str) -> ArchConfig:
    get_config(name)
    return _REDUCED[name]


def list_configs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


def assigned_archs() -> list[str]:
    """The 10 assigned architecture ids, in assignment order."""
    _load_all()
    return list(_ASSIGNED.values())
