"""Decoder-only transformer, dense path (port of
``repro/models/transformer.py``).

Layer parameters are stacked on a leading ``(n_super, ...)`` axis exactly as
the JAX package stacks them for ``lax.scan``, so the flat partition sees the
same three layer groups (``blocks``, ``embed``, ``final_norm``). The scan
becomes a Python loop over the stacked index; each iteration takes views of
the stacked leaves.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.pytree import tree_flatten, tree_unflatten
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec


def _check_dense(cfg) -> None:
    if (cfg.family != "dense" or cfg.num_experts or cfg.ssm_state
            or cfg.enc_dec or cfg.mrope or cfg.qk_norm
            or cfg.frontend is not None):
        raise NotImplementedError(
            f"{cfg.name!r} ({cfg.family}): the port builds dense decoders "
            "only so far (ROADMAP queue 1, item 14)")


# ---------------------------------------------------------------------------
# sub-layers
# ---------------------------------------------------------------------------


def attn_sublayer_specs(cfg, prefix):
    d = cfg.d_model
    La = tuple("layers" for _ in prefix)
    out = {"norm": ParamSpec(prefix + (d,), La + ("embed",), init="ones")}
    out.update(L.attention_specs(cfg, prefix))
    return out


def attn_sublayer(p, h, cfg, *, positions, window=0, causal=True):
    """Full-sequence attention (train). Returns (h', (k, v))."""
    x = L.rmsnorm(h, p["norm"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = L.apply_rope(q, positions, theta=cfg.rope_theta,
                     fraction=cfg.rope_fraction)
    k = L.apply_rope(k, positions, theta=cfg.rope_theta,
                     fraction=cfg.rope_fraction)
    out = L.attention(q, k, v, q_positions=positions, k_positions=positions,
                      causal=causal, window=window)
    o = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return h + o, (k, v)


def mlp_sublayer_specs(cfg, prefix):
    d = cfg.d_model
    La = tuple("layers" for _ in prefix)
    out = {"norm": ParamSpec(prefix + (d,), La + ("embed",), init="ones")}
    out.update(L.mlp_specs(cfg, cfg.d_ff, prefix))
    return out


def mlp_sublayer(p, h, cfg):
    x = L.rmsnorm(h, p["norm"], cfg.norm_eps)
    return h + L.mlp_apply(p, x), torch.zeros((), dtype=torch.float32,
                                              device=h.device)


# ---------------------------------------------------------------------------
# the whole decoder stack
# ---------------------------------------------------------------------------


def decoder_specs(cfg) -> Dict[str, Any]:
    """Same tree as the JAX package: dense layers repeat with period 1, so
    every leaf of ``blocks`` is stacked ``(num_layers, ...)``."""
    _check_dense(cfg)
    prefix = (cfg.num_layers,)
    sub: Dict[str, Any] = {"attn": attn_sublayer_specs(cfg, prefix)}
    if cfg.d_ff:
        sub["mlp"] = mlp_sublayer_specs(cfg, prefix)
    return {
        "embed": L.embed_specs(cfg),
        "blocks": {"sub0": sub},
        "final_norm": L.rmsnorm_spec(cfg.d_model),
    }


def decoder_forward(params, h, cfg, *, positions):
    """Run the stack over hidden states ``h`` (B, S, d). Returns
    (h, aux_loss, None), the JAX function's outputs without a cache."""
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    # one unbind per stacked leaf: its backward stacks the per-layer grads
    # in one pass (an index per layer would add a full-size zero-filled
    # gradient per layer)
    stacked, treedef = tree_flatten(params["blocks"]["sub0"])
    per_layer = [x.unbind(0) for x in stacked]
    for i in range(stacked[0].shape[0]):
        sub = tree_unflatten(treedef, [u[i] for u in per_layer])
        h, _ = attn_sublayer(sub["attn"], h, cfg, positions=positions,
                             window=cfg.sliding_window)
        if "mlp" in sub:
            h, aux = mlp_sublayer(sub["mlp"], h, cfg)
            aux_total = aux_total + aux
    return h, aux_total, None
