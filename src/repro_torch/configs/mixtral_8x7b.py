"""Mixtral 8x7B: sparse MoE with sliding-window attention.

[arXiv:2401.04088] 32L, d_model=4096, 32H (GQA kv=8), d_ff=14336 per expert,
vocab=32000, 8 experts top-2, SWA window 4096; the fields of
``repro/configs/mixtral_8x7b.py``.
"""
import torch

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    experts_per_token=2,
    moe_layer_period=1,
    sliding_window=4096,
    rope_theta=1e6,
    tie_embeddings=False,
    dtype=torch.bfloat16,
    source="arXiv:2401.04088",
))
