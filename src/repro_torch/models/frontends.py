"""Stub modality frontends (port of ``repro/models/frontends.py``).

As in the JAX package, the audio frontend (mel-spectrogram and conv codec)
and the vision encoder (ViT and projector) are stubs: the language or
decoder transformer consumes precomputed frame or patch embeddings of the
right shape. These helpers draw such embeddings and the VLM's 3-axis
M-RoPE positions, so that examples and tests run end to end. Each draw uses
the caller's ``torch.Generator`` and lands on the named device (the
generator's); the draws are not the JAX package's.
"""
from __future__ import annotations

import torch


def synth_patch_embeddings(generator, batch, seq, d_model, *,
                           dtype=torch.float32, device):
    """Stand-in for ViT patch embeddings mixed with text embeddings:
    N(0, 0.02²) drawn in float32, stored in ``dtype``."""
    return (torch.randn((batch, seq, d_model), generator=generator,
                        dtype=torch.float32, device=device) * 0.02).to(dtype)


def synth_mrope_positions(batch, seq, *, image_span=None, device):
    """(3, batch, seq) int32 t/h/w M-RoPE ids. Text tokens advance all axes
    together; an optional image span ``(s, e, grid)`` (tokens [s, e) form
    a grid x grid image) holds t at s and walks h, w over the grid."""
    idx = torch.arange(seq, device=device)
    t = h = w = idx
    if image_span is not None:
        s, e, grid = image_span
        in_img = (idx >= s) & (idx < e)
        rel = torch.clamp(idx - s, 0, grid * grid - 1)
        h = torch.where(in_img, s + rel // grid, h)
        w = torch.where(in_img, s + rel % grid, w)
        t = torch.where(in_img, torch.full_like(t, s), t)
    return torch.stack([t, h, w])[:, None].expand(3, batch, seq).to(
        torch.int32)


def synth_audio_frames(generator, batch, enc_seq, d_model, *,
                       dtype=torch.float32, device):
    """Stand-in for whisper's mel + conv frontend output
    (batch, enc_seq, d_model): N(0, 0.02²) drawn in float32, stored in
    ``dtype``."""
    return (torch.randn((batch, enc_seq, d_model), generator=generator,
                        dtype=torch.float32, device=device) * 0.02).to(dtype)
