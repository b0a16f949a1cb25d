"""Decoder-only stack: the dense and SSM families (port of
``repro/models/transformer.py``).

Layer parameters are stacked on a leading ``(n_super, ...)`` axis exactly as
the JAX package stacks them for ``lax.scan``: the stack repeats a
super-block of ``p`` sub-layers (``sub0`` … ``sub{p-1}``), ``p`` the
smallest period of the layer kinds (1 for a dense or an SSM decoder), so
the flat partition sees the same three layer groups (``blocks``, ``embed``,
``final_norm``). The scan becomes a Python loop over the stacked index;
each iteration takes views of the stacked leaves.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.pytree import tree_flatten, tree_unflatten
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.layers import ParamSpec


def _check_supported(cfg) -> None:
    """The families the port builds: dense and SSM decoders."""
    missing = [what for what, on in (
        ("mixture-of-experts layers", cfg.num_experts),
        ("hybrid attention/SSM interleave", cfg.family == "hybrid"),
        ("encoder-decoder", cfg.enc_dec), ("M-RoPE", cfg.mrope),
        (f"a {cfg.frontend} frontend", cfg.frontend is not None),
        ("qk_norm", cfg.qk_norm)) if on]
    if cfg.family not in ("dense", "ssm"):
        missing.append(f"the {cfg.family} family")
    if missing:
        raise NotImplementedError(
            f"{cfg.name!r} ({cfg.family}) needs {', '.join(missing)}: the "
            "port builds dense and SSM decoders only so far (ROADMAP queue "
            "1, item 14)")


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
    out = L.attention(q, k, v, causal=causal, window=window)
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


def ssm_sublayer_specs(cfg, prefix):
    d = cfg.d_model
    La = tuple("layers" for _ in prefix)
    out = {"norm": ParamSpec(prefix + (d,), La + ("embed",), init="ones")}
    out.update(S.ssm_specs(cfg, prefix))
    return out


def ssm_sublayer(p, h, cfg):
    """Pre-norm SSM block with its residual (train). Returns (h', None),
    the reference's outputs without the state it collects for prefill."""
    x = L.rmsnorm(h, p["norm"], cfg.norm_eps)
    return h + S.ssm_block_apply(p, x, cfg), None


# ---------------------------------------------------------------------------
# layer-type layout
# ---------------------------------------------------------------------------


def layer_kinds(cfg):
    """Per-layer (mixer_kind, use_moe): mixer_kind in {'attn','ssm'}."""
    return [("attn" if cfg.is_attn_layer(l) else "ssm", cfg.is_moe_layer(l))
            for l in range(cfg.num_layers)]


def _superblock_period(cfg) -> int:
    """Scan period: smallest p such that layer kinds repeat with period p."""
    kinds = layer_kinds(cfg)
    n = cfg.num_layers
    for p in range(1, n + 1):
        if n % p:
            continue
        if all(kinds[i] == kinds[i % p] for i in range(n)):
            return p
    return n


# ---------------------------------------------------------------------------
# the whole decoder stack
# ---------------------------------------------------------------------------


def decoder_specs(cfg) -> Dict[str, Any]:
    """Same tree as the JAX package: ``blocks/sub{i}/{attn|ssm}[, mlp]``,
    every leaf stacked ``(num_layers // period, ...)``."""
    _check_supported(cfg)
    kinds = layer_kinds(cfg)[:_superblock_period(cfg)]
    prefix = (cfg.num_layers // len(kinds),)
    blocks: Dict[str, Any] = {}
    for i, (mixer, _) in enumerate(kinds):
        if mixer == "attn":
            sub: Dict[str, Any] = {"attn": attn_sublayer_specs(cfg, prefix)}
        else:
            sub = {"ssm": ssm_sublayer_specs(cfg, prefix)}
        if cfg.d_ff:
            sub["mlp"] = mlp_sublayer_specs(cfg, prefix)
        blocks[f"sub{i}"] = sub
    return {
        "embed": L.embed_specs(cfg),
        "blocks": blocks,
        "final_norm": L.rmsnorm_spec(cfg.d_model),
    }


def decoder_layers(params):
    """The stack's layers in order: yields ``(layer, sub)``, ``sub`` the
    ``{attn|ssm[, mlp]}`` params of one layer (views of the stacked
    leaves). One unbind per stacked leaf: its backward stacks the
    per-layer grads in one pass (an index per layer would add a full-size
    zero-filled gradient per layer)."""
    blocks = params["blocks"]
    period = len(blocks)
    stacked, treedef = tree_flatten(blocks)
    per_super = [x.unbind(0) for x in stacked]
    for j in range(stacked[0].shape[0]):
        superblock = tree_unflatten(treedef, [u[j] for u in per_super])
        for i in range(period):
            yield j * period + i, superblock[f"sub{i}"]


def decoder_layer(sub, h, cfg, *, positions):
    """One layer: its mixer (attention or SSM), then its MLP if it has
    one. Returns (h, aux)."""
    if "attn" in sub:
        h, _ = attn_sublayer(sub["attn"], h, cfg, positions=positions,
                             window=cfg.sliding_window)
    else:
        h, _ = ssm_sublayer(sub["ssm"], h, cfg)
    if "mlp" in sub:
        return mlp_sublayer(sub["mlp"], h, cfg)
    return h, None


def decoder_forward(params, h, cfg, *, positions):
    """Run the stack over hidden states ``h`` (B, S, d). Returns
    (h, aux_loss, None), the JAX function's outputs without a cache."""
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for _, sub in decoder_layers(params):
        h, aux = decoder_layer(sub, h, cfg, positions=positions)
        if aux is not None:
            aux_total = aux_total + aux
    return h, aux_total, None
