"""GPT-2 XL (~1.6B): the paper's finetuning architecture (Table 3,
Wikitext-103)."""
import torch

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gpt2-xl",
    family="dense",
    num_layers=48,
    d_model=1600,
    num_heads=25,
    num_kv_heads=25,
    d_ff=6400,
    vocab_size=50257,
    tie_embeddings=True,
    dtype=torch.float32,
    source="paper (LayUp Table 3); GPT-2",
))
