"""Model configuration (jax-free port of ``repro/configs/base.py``).

``ModelConfig`` keeps every field of the JAX package's config, so a config
ports field for field; ``dtype`` is a ``torch.dtype``. The registry holds
all twelve configs of the JAX package's zoo: the dense decoders, the SSM
family (Mamba2), the mixture-of-experts family, the hybrid (Jamba), the VLM
backbone (Qwen2-VL, M-RoPE) and the encoder-decoder (Whisper). ``reduced``
derives the small same-family variant the tests build.

``ShapeConfig``, ``INPUT_SHAPES`` and ``input_specs`` are the step shapes of
the JAX package: ``input_specs`` gives one step's data inputs as
``(shape, dtype)`` pairs, the abstract tensors of the port (nothing is
allocated).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

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
# Input shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def input_specs(cfg: ModelConfig, shape: ShapeConfig, dtype=None
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """One step's data inputs as ``(shape, dtype)`` pairs. The decode kinds
    give the data inputs only: the model's ``cache_specs`` give the cache,
    whose layout depends on its layers (the encoder-decoder's cross K/V is
    part of it)."""
    dtype = dtype or cfg.dtype
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
        if cfg.frontend == "vision":
            # the stubbed frontend: mixed text and patch embeddings, and
            # the M-RoPE t/h/w ids
            specs["embeds"] = ((B, S, cfg.d_model), dtype)
            specs["positions"] = ((3, B, S), i32)
        elif cfg.frontend == "audio":
            specs["audio_embeds"] = ((B, cfg.enc_seq, cfg.d_model), dtype)
            specs["tokens"] = ((B, S), i32)
        else:
            specs["tokens"] = ((B, S), i32)
        if shape.kind == "train":
            specs["labels"] = ((B, S), i32)
        return specs
    if shape.kind == "decode":
        return {"token": ((B, 1), i32), "position": ((B,), i32)}
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}

_ARCH_MODULES = ["gpt2_medium", "gpt2_xl", "granite_8b", "jamba_v0_1_52b",
                 "mamba2_780m", "mixtral_8x7b", "moonshot_v1_16b_a3b",
                 "qwen2_vl_2b", "qwen3_moe_30b_a3b", "stablelm_1_6b",
                 "whisper_large_v3", "yi_34b"]


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _ensure_loaded():
    import importlib
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant: <=2 layers, d_model <= 512, <=4 experts
    (a copy of ``repro/configs/base.py::reduced``)."""
    kw: Dict[str, Any] = dict(
        name=cfg.name + "-reduced",
        num_layers=2,
        d_model=256,
        d_ff=512,
        vocab_size=512,
        head_dim=32,
        num_heads=4,
        num_kv_heads=(min(cfg.num_kv_heads, 2)
                      if cfg.num_kv_heads < cfg.num_heads else 4),
        dtype=torch.float32,
    )
    if cfg.num_experts:
        kw.update(num_experts=4,
                  experts_per_token=min(cfg.experts_per_token, 2),
                  moe_d_ff=128)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=32)
    if cfg.attn_layer_period:
        # keep the hybrid interleave visible with 2 layers: attn at layer 1
        kw.update(attn_layer_period=2)
    if cfg.enc_dec:
        kw.update(enc_layers=2, enc_seq=16)
    if cfg.sliding_window:
        kw.update(sliding_window=16)
    return cfg.with_(**kw)
