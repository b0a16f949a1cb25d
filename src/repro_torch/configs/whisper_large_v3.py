"""Whisper large-v3: encoder-decoder audio transformer.

[arXiv:2212.04356] 32L encoder + 32L decoder, d_model=1280, 20H (MHA),
d_ff=5120, vocab=51866, 1500 encoder frames. The mel-spectrogram and conv
feature extractor are a stub, as in the JAX package: the encoder takes
(B, 1500, 1280) frame embeddings (``models/frontends.py``). No RoPE
(``rope_theta=0``): sinusoidal positions on both sides
(``models/encdec.py``). The fields of ``repro/configs/whisper_large_v3.py``.
"""
import torch

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    enc_dec=True,
    enc_layers=32,
    enc_seq=1500,
    frontend="audio",
    rope_theta=0.0,
    tie_embeddings=True,
    dtype=torch.bfloat16,
    source="arXiv:2212.04356",
))
