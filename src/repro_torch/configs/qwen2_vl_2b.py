"""Qwen2-VL 2B: the VLM's language backbone with M-RoPE.

[arXiv:2409.12191] 28L, d_model=1536, 12H (GQA kv=2), d_ff=8960,
vocab=151936, M-RoPE over (t, h, w) position ids. The vision encoder is a
stub, as in the JAX package: the model takes mixed text and patch
embeddings with 3-axis positions (``models/frontends.py``). The fields of
``repro/configs/qwen2_vl_2b.py``.
"""
import torch

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    mrope=True,
    frontend="vision",
    rope_theta=1e6,
    tie_embeddings=True,
    dtype=torch.bfloat16,
    source="arXiv:2409.12191",
))
