"""GPT-2 Medium (~400M): the paper's own pre-training architecture
(LayUp Table 3: GPT-2 Medium on MiniPile), realized as a llama-style
pre-norm decoder at GPT-2 Medium dimensions."""
import torch

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gpt2-medium",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=50257,
    tie_embeddings=True,
    dtype=torch.float32,
    source="paper (LayUp Table 3); arXiv:1909.... GPT-2",
))
