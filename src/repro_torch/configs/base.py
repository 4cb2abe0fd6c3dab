"""Architecture configuration (the port's own copy of
``repro/configs/base.py``).

``ArchConfig`` describes a transformer-family model precisely enough to
build it; each of the reference's ten architectures has its own file next
to this module and registers itself via ``register``. Asking for an
unknown architecture raises ``KeyError``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Literal

Family = Literal["dense", "moe", "audio", "hybrid", "ssm", "vlm"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    router_jitter: float = 0.0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture. Field semantics follow the reference."""

    arch_id: str
    family: Family
    source: str

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 => d_model // n_heads

    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0

    moe: MoEConfig | None = None
    ssm_state: int = 0
    rwkv: bool = False
    frontend: Literal["none", "audio_frames", "vision_patches"] = "none"

    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """A workload shape (the reference's): sequence length, global batch,
    and whether it trains, prefills or decodes."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


ARCH_IDS = (
    "glm4-9b", "stablelm-3b", "qwen2-7b", "qwen3-4b", "moonshot-v1-16b-a3b",
    "kimi-k2-1t-a32b", "musicgen-large", "hymba-1.5b", "rwkv6-7b",
    "llava-next-mistral-7b",
)

_REGISTRY: dict[str, ArchConfig] = {}
_REDUCED: dict[str, Callable[[], ArchConfig]] = {}


def register(cfg: ArchConfig, reduced: Callable[[], ArchConfig]):
    _REGISTRY[cfg.arch_id] = cfg
    _REDUCED[cfg.arch_id] = reduced
    return cfg


def _check(arch_id: str) -> None:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")


def get_config(arch_id: str) -> ArchConfig:
    _check(arch_id)
    return _REGISTRY[arch_id]


def get_reduced_config(arch_id: str) -> ArchConfig:
    """Small same-family config for CPU smoke tests."""
    _check(arch_id)
    return _REDUCED[arch_id]()


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    for arch in ARCH_IDS:
        importlib.import_module(
            f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    _LOADED = True
