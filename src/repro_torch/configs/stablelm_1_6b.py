"""StableLM 2 1.6B: dense MHA decoder with partial rotary embedding.

[hf:stabilityai/stablelm-2-1_6b] 24L, d_model=2048, 32H (kv=32, i.e. MHA),
d_ff=5632, vocab=100352, rotary on 25% of head dims."""
import torch

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    rope_fraction=0.25,
    tie_embeddings=False,
    dtype=torch.bfloat16,
    source="hf:stabilityai/stablelm-2-1_6b",
))
