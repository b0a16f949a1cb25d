"""Jamba v0.1 52B: hybrid Mamba+attention 1:7 interleave with MoE.

[arXiv:2403.19887] 32L, d_model=4096, 32H (GQA kv=8), d_ff=14336,
vocab=65536, MoE 16 experts top-2 every second layer; 1 attention layer per
8-layer block, at position 4. The Mamba layers use d_state=16, conv=4,
expand=2, realized with the SSD block at that state size (Jamba uses
Mamba-1). The fields of ``repro/configs/jamba_v0_1_52b.py``.
"""
import torch

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_layer_period=2,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_layer_period=8,
    sliding_window=0,
    tie_embeddings=False,
    dtype=torch.bfloat16,
    source="arXiv:2403.19887",
))
