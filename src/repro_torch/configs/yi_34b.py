"""Yi-34B: deep dense llama-style GQA decoder.

[arXiv:2403.04652] 60L, d_model=7168, 56H (GQA kv=8), d_ff=20480,
vocab=64000."""
import torch

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5e6,
    tie_embeddings=False,
    dtype=torch.bfloat16,
    source="arXiv:2403.04652",
))
