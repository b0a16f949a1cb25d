"""Whisper-style encoder-decoder transformer (port of
``repro/models/encdec.py``).

The mel-spectrogram and conv frontend are a stub, as in the JAX package:
the encoder takes frame embeddings (B, enc_seq, d_model). Sinusoidal
positions are added on both sides (whisper has no RoPE; ``rope_theta=0``
turns the rotation off in the shared attention code).

The encoder's self-attention (``causal=False``), the decoder's causal
self-attention and its cross-attention to the encoder states (Sq = the
decoder's length, Sk = enc_seq, not causal) all go through
``layers.attention``: on a CUDA tensor the flash kernels #2-#4, as the
reference sends them to its Pallas kernels under ``USE_PALLAS``. The
decode step's cross-attention reads the cross cache through the plain
``layers.decode_attention``, as the reference's does. Layer parameters are
stacked ``(enc_layers, ...)`` and ``(num_layers, ...)`` as the JAX
package stacks them for its scans; the scans are loops over views, each
block a ``transformer.remat_block`` call as in the reference (looked up
through the module at call time).
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import ParamSpec


def cross_attn_specs(cfg, prefix):
    d = cfg.d_model
    La = tuple("layers" for _ in prefix)
    out = {"norm": ParamSpec(prefix + (d,), La + ("embed",), init="ones")}
    out.update(L.attention_specs(cfg, prefix))
    return out


def encdec_specs(cfg) -> Dict[str, Any]:
    ne, nd = cfg.enc_layers, cfg.num_layers
    enc_block = {
        "attn": T.attn_sublayer_specs(cfg, (ne,)),
        "mlp": T.mlp_sublayer_specs(cfg, (ne,), use_moe=False),
    }
    dec_block = {
        "attn": T.attn_sublayer_specs(cfg, (nd,)),
        "cross": cross_attn_specs(cfg, (nd,)),
        "mlp": T.mlp_sublayer_specs(cfg, (nd,), use_moe=False),
    }
    return {
        "embed": L.embed_specs(cfg),
        "enc_blocks": enc_block,
        "enc_norm": L.rmsnorm_spec(cfg.d_model),
        "dec_blocks": dec_block,
        "dec_norm": L.rmsnorm_spec(cfg.d_model),
    }


def _arange(B, S, device):
    return torch.arange(S, device=device)[None].expand(B, S)


def _cross_attn(p, h, enc_kv, cfg):
    """Full-sequence cross attention with its residual; enc_kv: (k, v) of
    the encoder states (B, Se, Hkv, D)."""
    x = L.rmsnorm(h, p["norm"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k, v = enc_kv
    out = L.attention(q, k, v, causal=False, window=0)
    return h + torch.einsum("bshk,hkd->bsd", out, p["wo"])


def encoder_block(cfg, h, bp, dc, ic):
    """One encoder block (the ``f`` of ``remat_block``): bidirectional
    self-attention, then the MLP."""
    del dc
    h, _ = T.attn_sublayer(bp["attn"], h, cfg, positions=ic["positions"],
                           causal=False)
    return T.mlp_sublayer(bp["mlp"], h, cfg, use_moe=False)[0]


def decoder_block(cfg, h, bp, dc, ic):
    """One decoder block (the ``f`` of ``remat_block``): causal
    self-attention, cross-attention to ``dc["enc_h"]`` (its K/V projected
    here, so the backward recomputes them), then the MLP."""
    h, _ = T.attn_sublayer(bp["attn"], h, cfg, positions=ic["positions"],
                           causal=True, window=cfg.sliding_window)
    xk = torch.einsum("bsd,dhk->bshk", dc["enc_h"], bp["cross"]["wk"])
    xv = torch.einsum("bsd,dhk->bshk", dc["enc_h"], bp["cross"]["wv"])
    h = _cross_attn(bp["cross"], h, (xk, xv), cfg)
    return T.mlp_sublayer(bp["mlp"], h, cfg, use_moe=False)[0]


def encode(params, audio_embeds, cfg):
    """audio_embeds: (B, enc_seq, d) stub-frontend output -> the encoder
    states (B, enc_seq, d), after ``enc_norm``."""
    B, Se, d = audio_embeds.shape
    h = audio_embeds + L.sinusoidal_positions(
        Se, d, device=audio_embeds.device).to(audio_embeds.dtype)
    ic = {"positions": _arange(B, Se, h.device)}
    block = T.remat_block(partial(encoder_block, cfg))
    for bp in T.stacked_layers(params["enc_blocks"]):
        h = block(h, bp, {}, ic)
    return L.rmsnorm(h, params["enc_norm"], cfg.norm_eps)


def decode_train(params, enc_h, tokens, cfg):
    """Teacher-forced decoder pass -> float32 logits (B, S, V)."""
    B, S = tokens.shape
    h = L.embed_apply(params["embed"], tokens)
    h = h + L.sinusoidal_positions(S, cfg.d_model,
                                   device=h.device).to(h.dtype)
    ic = {"positions": _arange(B, S, h.device)}
    block = T.remat_block(partial(decoder_block, cfg))
    for bp in T.stacked_layers(params["dec_blocks"]):
        h = block(h, bp, {"enc_h": enc_h}, ic)
    h = L.rmsnorm(h, params["dec_norm"], cfg.norm_eps)
    return L.unembed_apply(params["embed"], h, cfg.tie_embeddings)


def cross_kv(params, enc_h):
    """Every decoder layer's cross K and V of the encoder states: two
    (num_layers, B, enc_seq, Hkv, D) tensors, the decode cache's
    ``cross``."""
    cross = params["dec_blocks"]["cross"]
    return (torch.einsum("bsd,ldhk->lbshk", enc_h, cross["wk"]),
            torch.einsum("bsd,ldhk->lbshk", enc_h, cross["wv"]))


def decode_step(params, cache, token, position, cfg, *, window=0):
    """One decoder token a sequence: token (B, 1), position (B,).
    cache: {"self": K/V stacked (num_layers, B, Sc, Hkv, D), written in
    place at each sequence's slot, "cross": the read-only cross K/V}.
    Returns (float32 logits (B, 1, V), cache)."""
    B = token.shape[0]
    h = L.embed_apply(params["embed"], token)  # (B, 1, d)
    h = h + _sinusoid_at(position, cfg.d_model).to(h.dtype)[:, None, :]
    Se = cache["cross"]["k"].shape[2]
    enc_positions = _arange(B, Se, h.device)
    for j, bp in enumerate(T.stacked_layers(params["dec_blocks"])):
        self_cache = {k: v[j] for k, v in cache["self"].items()}
        h, _ = T.attn_sublayer_decode(bp["attn"], h, cfg, self_cache,
                                      position=position, window=window)
        x = L.rmsnorm(h, bp["cross"]["norm"], cfg.norm_eps)
        q = torch.einsum("bsd,dhk->bshk", x, bp["cross"]["wq"])
        out = L.decode_attention(q, cache["cross"]["k"][j],
                                 cache["cross"]["v"][j], q_position=position,
                                 k_positions=enc_positions, causal=False)
        h = h + torch.einsum("bshk,hkd->bsd", out, bp["cross"]["wo"])
        h, _ = T.mlp_sublayer(bp["mlp"], h, cfg, use_moe=False)
    h = L.rmsnorm(h, params["dec_norm"], cfg.norm_eps)
    return L.unembed_apply(params["embed"], h, cfg.tie_embeddings), cache


def _sinusoid_freqs(d_model: int) -> np.ndarray:
    half = d_model // 2
    return (1.0 / np.power(10000.0, np.arange(half, dtype=np.float32) * 2
                           / d_model)).astype(np.float32)


def _sinusoid_at(position, d_model):
    """position: (B,) -> (B, d_model) float32 sinusoidal embedding (sin at
    even, cos at odd features), the row ``position`` of
    ``layers.sinusoidal_positions``."""
    freqs = L._device_table(("sinusoid_freqs", d_model),
                            lambda: _sinusoid_freqs(d_model),
                            position.device)
    ang = position.to(torch.float32)[:, None] * freqs[None, :]
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
        position.shape[0], d_model)


def encdec_cache_specs(cfg, B, seq_len, window, dtype=None):
    dt = dtype or cfg.dtype
    nd = cfg.num_layers
    self_specs = T.attn_cache_specs(cfg, B, seq_len, window, (nd,), dt)
    sh = (nd, B, cfg.enc_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"self": self_specs,
            "cross": {"k": T.CacheSpec(sh, dt), "v": T.CacheSpec(sh, dt)}}
