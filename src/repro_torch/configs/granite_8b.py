"""Granite 8B (code): llama-style dense GQA decoder.

[arXiv:2405.04324] 36L, d_model=4096, 32H (GQA kv=8), d_ff=14336,
vocab=49152."""
import torch

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    rope_theta=1e4,
    tie_embeddings=True,
    dtype=torch.bfloat16,
    source="arXiv:2405.04324",
))
