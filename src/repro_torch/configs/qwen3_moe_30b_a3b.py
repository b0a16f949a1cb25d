"""Qwen3-30B-A3B: fine-grained MoE, 128 experts top-8, QK-norm.

[hf:Qwen/Qwen3-30B-A3B] 48L, d_model=2048, 32H (GQA kv=4, head_dim=128 so
the q projection is 4096 wide, not d_model), per-expert d_ff=768,
vocab=151936; the fields of ``repro/configs/qwen3_moe_30b_a3b.py``.
"""
import torch

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
    moe_layer_period=1,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    dtype=torch.bfloat16,
    source="hf:Qwen/Qwen3-30B-A3B",
))
