"""Mamba2 780M: attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060] 48L, d_model=1536, d_state=128, expand=2, head_dim=64,
vocab=50280; the fields of ``repro/configs/mamba2_780m.py``.
"""
import torch

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=64,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
    dtype=torch.bfloat16,
    source="arXiv:2405.21060",
))
