"""Model API (port of ``repro/models/model.py``, the dense and SSM
decoders).

``build_model(cfg)`` returns a ``Model`` bundle of functions over a params
dict of the JAX package's tree:

  loss_fn(params, batch)   (scalar loss, metrics dict), teacher-forced LM
  prefill_fn(params, batch) -> (cache, last_logits)
  decode_fn(params, cache, token, position) -> (logits, cache)
  cache_specs(B, seq_len)  ``CacheSpec`` tree (``transformer.alloc_cache``
                           makes the zeros on a named device)

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


def _decoder_embed_inputs(params, batch, cfg):
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = L.embed_apply(params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    return h, positions


def _build_decoder_model(cfg: ModelConfig) -> Model:
    specs = T.decoder_specs(cfg)

    def loss_fn(params, batch):
        h, positions = _decoder_embed_inputs(params, batch, cfg)
        h, aux, _ = T.decoder_forward(params, h, cfg, positions=positions)
        h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
        logits = L.unembed_apply(params["embed"], h, cfg.tie_embeddings)
        ce = L.cross_entropy(logits, batch["labels"])
        loss = ce + cfg.router_aux_weight * aux
        return loss, {"ce": ce, "aux": aux}

    @torch.inference_mode()
    def prefill_fn(params, batch):
        """The full-sequence path over ``batch["tokens"]`` (B, S): the
        attention goes through ``layers.attention`` (the flash forward on
        a CUDA tensor). Returns the cache of the S positions and the last
        position's float32 logits (B, 1, V)."""
        h, positions = _decoder_embed_inputs(params, batch, cfg)
        h, _, cache = T.decoder_forward(params, h, cfg, positions=positions,
                                        collect_cache=True)
        h = L.rmsnorm(h[:, -1:], params["final_norm"], cfg.norm_eps)
        logits = L.unembed_apply(params["embed"], h, cfg.tie_embeddings)
        return cache, logits

    @torch.inference_mode()
    def decode_fn(params, cache, token, position):
        """One token a sequence: token (B, 1), position (B,) the cache
        position it is written at. Returns float32 logits (B, 1, V) and
        ``cache``, updated in place."""
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


def build_model(cfg: ModelConfig) -> Model:
    """Dense and SSM decoders both go through the one decoder path; other
    families raise ``NotImplementedError`` (``transformer.decoder_specs``)."""
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
