"""Model configuration (jax-free port of ``repro/configs/base.py``).

``ModelConfig`` keeps every field of the JAX package's config, so a config
ports field for field; ``dtype`` is a ``torch.dtype``. The registry holds
the dense decoders the port can build. The other families of the JAX
package's zoo are named here so that asking for one says what is missing.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (decoder-only unless ``enc_dec``)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 1
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (mamba2-style SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    attn_layer_period: int = 0

    # attention details
    sliding_window: int = 0  # 0 -> full attention
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    qk_norm: bool = False
    mrope: bool = False

    # encoder-decoder (whisper)
    enc_dec: bool = False
    enc_layers: int = 0
    enc_seq: int = 1500

    frontend: Optional[str] = None

    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    dtype: Any = torch.float32

    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_attn_layer(self, l: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_layer_period <= 0:
            return True
        return (l % self.attn_layer_period) == self.attn_layer_period // 2

    def is_moe_layer(self, l: int) -> bool:
        if self.num_experts == 0:
            return False
        return (l % self.moe_layer_period) == self.moe_layer_period - 1

    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_counts(self) -> Dict[str, float]:
        """Approximate total and active parameter counts."""
        d, V = self.d_model, self.vocab_size
        embed = V * d * (1 if self.tie_embeddings else 2)

        def attn_params():
            return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

        def dense_mlp():
            return 3 * d * self.d_ff

        def moe_mlp(active: bool):
            e = self.experts_per_token if active else self.num_experts
            return 3 * d * self.expert_d_ff() * e + d * self.num_experts

        def ssm_params():
            di = self.d_inner
            return (d * (2 * di + 2 * self.ssm_state + self.ssm_heads)
                    + di * self.ssm_conv + di * d)

        total = embed
        active = embed
        for l in range(self.num_layers):
            if self.family in ("ssm", "hybrid") and not self.is_attn_layer(l):
                total += ssm_params(); active += ssm_params()
            else:
                total += attn_params(); active += attn_params()
                if self.enc_dec:
                    total += attn_params(); active += attn_params()
            if self.is_moe_layer(l):
                total += moe_mlp(False); active += moe_mlp(True)
            else:
                total += dense_mlp(); active += dense_mlp()
        if self.enc_dec:
            for _ in range(self.enc_layers):
                total += attn_params() + dense_mlp()
                active += attn_params() + dense_mlp()
        return {"total": float(total), "active": float(active)}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}

_ARCH_MODULES = ["gpt2_medium", "gpt2_xl", "granite_8b", "stablelm_1_6b",
                 "yi_34b"]

# configs of the JAX package whose families the port cannot build yet
_NOT_PORTED = {
    "jamba-v0.1-52b": "hybrid", "mamba2-780m": "ssm",
    "mixtral-8x7b": "moe", "moonshot-v1-16b-a3b": "moe",
    "qwen2-vl-2b": "vlm", "qwen3-moe-30b-a3b": "moe",
    "whisper-large-v3": "audio",
}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _ensure_loaded():
    import importlib
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name!r} is a {_NOT_PORTED[name]} model; the port builds dense "
            "decoders only so far (ROADMAP queue 1, item 14)")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    _ensure_loaded()
    return sorted(_REGISTRY)
