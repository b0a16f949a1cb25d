"""Model API (port of ``repro/models/model.py``): the decoder families
(dense, SSM, mixture-of-experts, hybrid, the VLM backbone) and the
encoder-decoder (Whisper).

``build_model(cfg)`` returns a ``Model`` bundle of functions over a params
dict of the JAX package's tree:

  loss_fn(params, batch)   (scalar loss, {"ce", "aux"}), teacher-forced LM;
                           loss = ce + router_aux_weight * aux (the MoE
                           layers' load-balance loss, 0 without them).
                           A batch holds "tokens" and "labels" (B, S);
                           the VLM's holds "embeds" (B, S, d) and
                           "positions" (3, B, S) in place of tokens;
                           Whisper's adds "audio_embeds" (B, enc_seq, d)
  prefill_fn(params, batch) -> (cache, last_logits)
  decode_fn(params, cache, token, position) -> (logits, cache)
  cache_specs(B, seq_len)  ``CacheSpec`` tree (``transformer.alloc_cache``
                           makes the zeros on a named device)
  abstract_params()        the params tree on the ``meta`` device
  logical_axes()           each parameter's logical axis names

``prefill_fn`` and ``decode_fn`` run under ``torch.inference_mode()``;
``decode_fn`` writes ``cache`` in place and returns it. ``DecoderLM``
wraps ``loss_fn`` as an ``nn.Module`` for callers that want parameters
registered on a module.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pytree import tree_flatten_with_path
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    specs: Any
    loss_fn: Callable
    prefill_fn: Callable
    decode_fn: Callable
    cache_specs: Callable

    def init(self, seed: int = 0, *, device=None, dtype=None):
        return L.init_params(self.specs, seed=seed,
                             dtype=dtype or self.cfg.dtype, device=device)

    def abstract_params(self, dtype=None):
        """The params tree on the ``meta`` device (nothing allocated)."""
        return L.abstract_params(self.specs, dtype or self.cfg.dtype)

    def logical_axes(self):
        return L.logical_axes(self.specs)


def _decoder_embed_inputs(params, batch, cfg):
    """Embed the tokens, or take the stub frontend's embeddings; returns
    (h, positions (B, S), mrope_pos (3, B, S) or None). The VLM's
    temporal axis doubles as the positions."""
    if cfg.frontend == "vision":
        mrope_pos = batch["positions"]
        return batch["embeds"], mrope_pos[0], mrope_pos
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = L.embed_apply(params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    return h, positions, None


def _build_decoder_model(cfg: ModelConfig) -> Model:
    specs = T.decoder_specs(cfg)

    def loss_fn(params, batch):
        h, positions, mrope_pos = _decoder_embed_inputs(params, batch, cfg)
        h, aux, _ = T.decoder_forward(params, h, cfg, positions=positions,
                                      mrope_pos=mrope_pos)
        h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
        logits = L.unembed_apply(params["embed"], h, cfg.tie_embeddings)
        ce = L.cross_entropy(logits, batch["labels"])
        loss = ce + cfg.router_aux_weight * aux
        return loss, {"ce": ce, "aux": aux}

    @torch.inference_mode()
    def prefill_fn(params, batch):
        """The full-sequence path over ``batch["tokens"]`` (B, S) (the
        VLM's: ``batch["embeds"]`` and ``batch["positions"]``): the
        attention goes through ``layers.attention`` (the flash forward on
        a CUDA tensor). Returns the cache of the S positions and the last
        position's float32 logits (B, 1, V)."""
        h, positions, mrope_pos = _decoder_embed_inputs(params, batch, cfg)
        h, _, cache = T.decoder_forward(params, h, cfg, positions=positions,
                                        mrope_pos=mrope_pos,
                                        collect_cache=True)
        h = L.rmsnorm(h[:, -1:], params["final_norm"], cfg.norm_eps)
        logits = L.unembed_apply(params["embed"], h, cfg.tie_embeddings)
        return cache, logits

    @torch.inference_mode()
    def decode_fn(params, cache, token, position):
        """One token a sequence: token (B, 1), position (B,) the cache
        position it is written at. Returns float32 logits (B, 1, V) and
        ``cache``, updated in place (a bf16 SSM state entry is replaced
        by its float32 promotion on the first step)."""
        h = L.embed_apply(params["embed"], token)
        h, cache = T.decoder_decode_step(params, h, cfg, cache,
                                         position=position,
                                         window=cfg.sliding_window)
        h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
        logits = L.unembed_apply(params["embed"], h, cfg.tie_embeddings)
        return logits, cache

    def cache_specs(B, seq_len, dtype=None):
        return T.decoder_cache_specs(cfg, B, seq_len, cfg.sliding_window,
                                     dtype)

    return Model(cfg, specs, loss_fn, prefill_fn, decode_fn, cache_specs)


def _build_encdec_model(cfg: ModelConfig) -> Model:
    specs = ED.encdec_specs(cfg)

    def loss_fn(params, batch):
        enc_h = ED.encode(params, batch["audio_embeds"], cfg)
        logits = ED.decode_train(params, enc_h, batch["tokens"], cfg)
        ce = L.cross_entropy(logits, batch["labels"])
        return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                                 device=ce.device)}

    @torch.inference_mode()
    def prefill_fn(params, batch):
        """The decode cache of ``batch["audio_embeds"]``: the encoder pass,
        every layer's cross K/V, a zeroed self cache of
        ``batch["tokens"].shape[1]`` slots; then the decode step of the
        first token at position 0. Returns (cache, its float32 logits
        (B, 1, V)); feeding the later tokens is the caller's."""
        enc_h = ED.encode(params, batch["audio_embeds"], cfg)
        xk, xv = ED.cross_kv(params, enc_h)
        B, S = batch["tokens"].shape
        self_cache = T.alloc_cache(
            T.attn_cache_specs(cfg, B, S, cfg.sliding_window,
                               (cfg.num_layers,), cfg.dtype),
            device=enc_h.device)
        cache = {"self": self_cache, "cross": {"k": xk, "v": xv}}
        logits, cache = ED.decode_step(
            params, cache, batch["tokens"][:, :1],
            torch.zeros((B,), dtype=torch.int64, device=enc_h.device), cfg,
            window=cfg.sliding_window)
        return cache, logits

    @torch.inference_mode()
    def decode_fn(params, cache, token, position):
        """One token a sequence against the cache ``prefill_fn`` built;
        the self cache is written in place."""
        return ED.decode_step(params, cache, token, position, cfg,
                              window=cfg.sliding_window)

    def cache_specs(B, seq_len, dtype=None):
        return ED.encdec_cache_specs(cfg, B, seq_len, cfg.sliding_window,
                                     dtype)

    return Model(cfg, specs, loss_fn, prefill_fn, decode_fn, cache_specs)


def build_model(cfg: ModelConfig) -> Model:
    """The encoder-decoder for ``cfg.enc_dec``; every other family goes
    through the one decoder path."""
    if cfg.enc_dec:
        return _build_encdec_model(cfg)
    return _build_decoder_model(cfg)


class DecoderLM(nn.Module):
    """``nn.Module`` over a params dict: ``forward(batch)`` returns the
    loss. Parameters are registered under their tree paths with ``/`` as
    the separator; ``params()`` rebuilds the nested dict of (shared)
    tensors that ``loss_fn`` takes."""

    def __init__(self, model: Model, params: Dict[str, Any]):
        super().__init__()
        self.model = model
        flat, _ = tree_flatten_with_path(params)
        self._paths = [tuple(e.key for e in path) for path, _ in flat]
        self.weights = nn.ParameterDict(
            {"/".join(p): nn.Parameter(leaf)
             for p, (_, leaf) in zip(self._paths, flat)})

    def params(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for path in self._paths:
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = self.weights["/".join(path)]
        return out

    def forward(self, batch) -> torch.Tensor:
        return self.model.loss_fn(self.params(), batch)[0]
