"""Deterministic synthetic datasets with learnable structure.

A numpy copy of ``repro/data/synthetic.py`` (which imports jax at its top):
the same generators, draw for draw, so a seed gives bit-identical batches in
both packages. Batches are numpy arrays; ``repro_torch.convert`` moves them
to a device.

* ``SyntheticLM``: a Markov-chain language from a fixed random transition
  matrix; its conditional entropy is the irreducible loss floor. The matrix
  is ``vocab x vocab`` float64, so it suits small vocabularies only.
* ``SyntheticVision``: a k-class Gaussian-prototype task.

``lm_batch_for`` draws a random batch of the shape a model family takes
(tokens; the VLM's embeddings with M-RoPE positions; Whisper's audio
frames with tokens) from a ``torch.Generator``, as tensors on a device:
its draws are not the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.models.frontends import (synth_audio_frames,
                                          synth_patch_embeddings)


@dataclass
class SyntheticLM:
    vocab: int = 256
    seq_len: int = 64
    temperature: float = 1.5
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        logits = rng.normal(size=(self.vocab, self.vocab)) * self.temperature
        self.trans = np.exp(logits - logits.max(-1, keepdims=True))
        self.trans /= self.trans.sum(-1, keepdims=True)
        p_stat = np.full(self.vocab, 1.0 / self.vocab)
        for _ in range(50):
            p_stat = p_stat @ self.trans
        self.entropy = float(-(p_stat[:, None] * self.trans
                               * np.log(self.trans + 1e-12)).sum())

    def sample(self, rng: np.random.Generator, batch: int
               ) -> Dict[str, np.ndarray]:
        toks = np.empty((batch, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch)
        cdf = np.cumsum(self.trans, axis=-1)
        for t in range(self.seq_len):
            u = rng.random(batch)
            toks[:, t + 1] = (u[:, None] < cdf[toks[:, t]]).argmax(-1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclass
class SyntheticVision:
    num_classes: int = 10
    dim: int = 256
    snr: float = 0.35
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.prototypes = rng.normal(
            size=(self.num_classes, self.dim)).astype(np.float32)
        self.prototypes /= np.linalg.norm(self.prototypes, axis=-1,
                                          keepdims=True)

    def sample(self, rng: np.random.Generator, batch: int
               ) -> Dict[str, np.ndarray]:
        y = rng.integers(0, self.num_classes, batch)
        x = (self.snr * self.prototypes[y]
             + rng.normal(size=(batch, self.dim)).astype(np.float32))
        return {"x": x.astype(np.float32), "labels": y.astype(np.int32)}


def make_worker_batches(dataset, num_workers: int, batch_per_worker: int,
                        step: int, epoch_seed: int = 0):
    """Deterministic per-(worker, step) batches, disjoint within an epoch,
    stacked on a leading worker axis."""
    out = []
    for w in range(num_workers):
        rng = np.random.default_rng(
            (epoch_seed * 1_000_003 + step) * 64 + w)
        out.append(dataset.sample(rng, batch_per_worker))
    return {k: np.stack([b[k] for b in out]) for k in out[0]}


def lm_batch_for(cfg, batch: int, seq: int, *, generator, device
                 ) -> Dict[str, torch.Tensor]:
    """A random batch matching what ``cfg``'s model takes (the port of the
    reference's ``lm_batch_for``): ``labels`` (batch, seq) int32 with
    ``tokens`` (batch, seq) int32; for a vision frontend ``embeds``
    (batch, seq, d_model) in ``cfg.dtype`` and ``positions`` (3, batch,
    seq) int32, ``arange`` on every axis, in place of tokens; for an audio
    frontend also ``audio_embeds`` (batch, enc_seq, d_model). Draws from
    ``generator`` on ``device``."""
    def tokens():
        return torch.randint(0, cfg.vocab_size, (batch, seq),
                             generator=generator, dtype=torch.int32,
                             device=device)

    out: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "vision":
        out["embeds"] = synth_patch_embeddings(generator, batch, seq,
                                               cfg.d_model, dtype=cfg.dtype,
                                               device=device)
        out["positions"] = torch.arange(
            seq, dtype=torch.int32, device=device).expand(3, batch, seq)
    elif cfg.frontend == "audio":
        out["audio_embeds"] = synth_audio_frames(
            generator, batch, cfg.enc_seq, cfg.d_model, dtype=cfg.dtype,
            device=device)
        out["tokens"] = tokens()
    else:
        out["tokens"] = tokens()
    out["labels"] = tokens()
    return out
