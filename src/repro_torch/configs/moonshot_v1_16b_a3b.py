"""Moonlight-16B-A3B (moonshot): fine-grained MoE, 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B] 48L, d_model=2048, 16H (kv=16: MHA),
per-expert d_ff=1408, vocab=163840; the fields of
``repro/configs/moonshot_v1_16b_a3b.py``.
"""
import torch

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    moe_d_ff=1408,
    moe_layer_period=1,
    rope_theta=5e4,
    tie_embeddings=True,
    dtype=torch.bfloat16,
    source="hf:moonshotai/Moonlight-16B-A3B",
))
