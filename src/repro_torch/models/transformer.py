"""Decoder-only stack: the dense, SSM, mixture-of-experts, hybrid and VLM
families (port of ``repro/models/transformer.py``).

Layer parameters are stacked on a leading ``(n_super, ...)`` axis exactly as
the JAX package stacks them for ``lax.scan``: the stack repeats a
super-block of ``p`` sub-layers (``sub0`` … ``sub{p-1}``), ``p`` the
smallest period of the layer kinds (1 for a dense or an SSM decoder), so
the flat partition sees the same three layer groups (``blocks``, ``embed``,
``final_norm``). The hybrid (Jamba) repeats a super-block of
``attn_layer_period`` sub-layers: attention at ``sub{period // 2}``, SSM
elsewhere, an MoE on every ``moe_layer_period``-th. The VLM backbone
(``cfg.mrope``) rotates q and k by M-RoPE over (3, B, S) position ids. The scan becomes a Python loop over the stacked index;
each iteration takes views of the stacked leaves. A training forward runs
each super-block through ``remat_block``, as the reference's scan body
does: the backward keeps only the block inputs and recomputes the rest.
The decode step loops the same way and writes the cache in place (the
reference's jitted serve step donates its cache).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.pytree import tree_flatten, tree_map, tree_unflatten
from repro_torch.models import layers as L
from repro_torch.models import moe as MoE
from repro_torch.models import ssm as S
from repro_torch.models.layers import ParamSpec


def remat_block(f):
    """Per-block activation checkpointing (the reference's
    ``remat_block``): ``f(h, p, dc, ic)``, ``p`` the block's parameter
    tree, ``dc`` differentiable consts (encoder states), ``ic`` integer
    consts (positions, M-RoPE ids).

    While a graph is recorded the block keeps only its inputs alive; the
    backward runs ``f`` again and differentiates the recomputed forward
    (non-reentrant ``torch.utils.checkpoint``, which takes
    ``torch.autograd.grad``; the cotangents come back in the inputs'
    dtypes, as the reference casts them). Outside a recorded graph
    (``no_grad``, ``inference_mode``) it is ``f``. The models draw no
    random numbers in a forward, so no RNG state is saved per block; the
    recompute repeats the first forward bit for bit, and so do the
    gradients."""

    def wrapped(h, p, dc, ic):
        if not torch.is_grad_enabled():
            return f(h, p, dc, ic)
        return checkpoint(f, h, p, dc, ic, use_reentrant=False,
                          preserve_rng_state=False)

    return wrapped


# ---------------------------------------------------------------------------
# sub-layers
# ---------------------------------------------------------------------------


def attn_sublayer_specs(cfg, prefix):
    d = cfg.d_model
    La = tuple("layers" for _ in prefix)
    out = {"norm": ParamSpec(prefix + (d,), La + ("embed",), init="ones")}
    out.update(L.attention_specs(cfg, prefix))
    return out


def _project_qkv(p, x, cfg):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = L.rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = L.rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _rope_qk(q, k, cfg, positions, mrope_pos):
    if cfg.mrope and mrope_pos is not None:
        return (L.apply_mrope(q, mrope_pos, theta=cfg.rope_theta),
                L.apply_mrope(k, mrope_pos, theta=cfg.rope_theta))
    return (L.apply_rope(q, positions, theta=cfg.rope_theta,
                         fraction=cfg.rope_fraction),
            L.apply_rope(k, positions, theta=cfg.rope_theta,
                         fraction=cfg.rope_fraction))


def attn_sublayer(p, h, cfg, *, positions, mrope_pos=None, window=0,
                  causal=True):
    """Full-sequence attention (train / prefill). Returns (h', (k, v)).
    ``positions`` (B, S) (or ``mrope_pos`` (3, B, S) under ``cfg.mrope``)
    rotate q and k; the mask is derived from indices, as the reference's
    kernel route derives it (``layers.attention``)."""
    x = L.rmsnorm(h, p["norm"], cfg.norm_eps)
    q, k, v = _project_qkv(p, x, cfg)
    q, k = _rope_qk(q, k, cfg, positions, mrope_pos)
    out = L.attention(q, k, v, causal=causal, window=window)
    o = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return h + o, (k, v)


def attn_sublayer_decode(p, h, cfg, cache, *, position, window=0):
    """One-token attention against the KV cache (possibly ring-buffered).

    cache: {"k": (B, Sc, Hkv, hd), "v": ...}, written in place at each
    sequence's slot; position: (B,) integer. Returns (h', cache)."""
    B = h.shape[0]
    Sc = cache["k"].shape[1]
    x = L.rmsnorm(h, p["norm"], cfg.norm_eps)
    q, k, v = _project_qkv(p, x, cfg)
    # M-RoPE: a text token's position on all three axes
    mp = position[None, :, None].expand(3, B, 1) if cfg.mrope else None
    q, k = _rope_qk(q, k, cfg, position[:, None], mp)
    position = position.long()
    slot = (torch.remainder(position, Sc) if window > 0
            else torch.clamp(position, max=Sc - 1))
    rows = torch.arange(B, device=h.device)
    cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
    idx = torch.arange(Sc, device=h.device)[None, :]
    if window > 0:
        # ring buffer: slot i holds the largest pos' <= pos with
        # pos' = i (mod Sc)
        k_positions = position[:, None] - torch.remainder(
            position[:, None] - idx, Sc)
    else:
        k_positions = idx.expand(B, Sc)
    out = L.decode_attention(q, cache["k"], cache["v"], q_position=position,
                             k_positions=k_positions, window=window)
    o = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return h + o, cache


@dataclass(frozen=True)
class CacheSpec:
    """Shape and dtype of one cache leaf, the counterpart of
    ``jax.ShapeDtypeStruct``."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def attn_cache_specs(cfg, B, seq_len, window, prefix=(), dtype=None):
    Sc = min(seq_len, window) if window > 0 else seq_len
    dt = dtype or cfg.dtype
    sh = tuple(prefix) + (B, Sc, cfg.num_kv_heads, cfg.head_dim)
    return {"k": CacheSpec(sh, dt), "v": CacheSpec(sh, dt)}


def mlp_sublayer_specs(cfg, prefix, *, use_moe):
    d = cfg.d_model
    La = tuple("layers" for _ in prefix)
    out = {"norm": ParamSpec(prefix + (d,), La + ("embed",), init="ones")}
    if use_moe:
        out.update(MoE.moe_specs(cfg, prefix))
    else:
        out.update(L.mlp_specs(cfg, cfg.d_ff, prefix))
    return out


def mlp_sublayer(p, h, cfg, *, use_moe):
    """Pre-norm MLP or MoE block with its residual. Returns (h', aux), aux
    the MoE's load-balance loss, None for a dense MLP (whose aux is 0)."""
    x = L.rmsnorm(h, p["norm"], cfg.norm_eps)
    if use_moe:
        y, aux = MoE.moe_apply(p, x, cfg)
        return h + y, aux
    return h + L.mlp_apply(p, x), None


def ssm_sublayer_specs(cfg, prefix):
    d = cfg.d_model
    La = tuple("layers" for _ in prefix)
    out = {"norm": ParamSpec(prefix + (d,), La + ("embed",), init="ones")}
    out.update(S.ssm_specs(cfg, prefix))
    return out


def ssm_sublayer(p, h, cfg, *, return_state=False):
    """Pre-norm SSM block with its residual (train / prefill). Returns
    (h', (state, conv_tail)) with ``return_state``, else (h', None)."""
    x = L.rmsnorm(h, p["norm"], cfg.norm_eps)
    if return_state:
        y, st = S.ssm_block_apply(p, x, cfg, return_state=True)
        return h + y, st
    return h + S.ssm_block_apply(p, x, cfg), None


def ssm_sublayer_decode(p, h, cfg, cache):
    """One-token SSM step; the conv tail is written into ``cache`` in
    place. The new state is too where the cache holds the recurrence's
    dtype; a narrower state (a bf16 cache's first step: the float32 decay
    promotes it) replaces the entry, as the reference's step hands back
    its promoted state, so the recurrence carries float32 from the second
    step on. Returns (h', cache)."""
    x = L.rmsnorm(h, p["norm"], cfg.norm_eps)
    y, (st, tail) = S.ssm_block_decode(p, x, cfg, cache["state"],
                                       cache["conv_tail"])
    if st.dtype == cache["state"].dtype:
        cache["state"].copy_(st)
    else:
        cache["state"] = st
    cache["conv_tail"].copy_(tail)
    return h + y, cache


def ssm_cache_specs(cfg, B, prefix=(), dtype=None):
    dt = dtype or cfg.dtype
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    prefix = tuple(prefix)
    return {
        "state": CacheSpec(
            prefix + (B, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim), dt),
        "conv_tail": CacheSpec(prefix + (B, cfg.ssm_conv - 1, conv_dim), dt),
    }


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
    """Same tree as the JAX package: ``blocks/sub{i}/{attn|ssm}[, mlp]``
    (``mlp`` a dense MLP or, on an MoE layer, the router and experts),
    every leaf stacked ``(num_layers // period, ...)``."""
    kinds = layer_kinds(cfg)[:_superblock_period(cfg)]
    prefix = (cfg.num_layers // len(kinds),)
    blocks: Dict[str, Any] = {}
    for i, (mixer, use_moe) in enumerate(kinds):
        if mixer == "attn":
            sub: Dict[str, Any] = {"attn": attn_sublayer_specs(cfg, prefix)}
        else:
            sub = {"ssm": ssm_sublayer_specs(cfg, prefix)}
        if cfg.d_ff or cfg.num_experts:
            sub["mlp"] = mlp_sublayer_specs(cfg, prefix, use_moe=use_moe)
        blocks[f"sub{i}"] = sub
    return {
        "embed": L.embed_specs(cfg),
        "blocks": blocks,
        "final_norm": L.rmsnorm_spec(cfg.d_model),
    }


def stacked_layers(tree):
    """The per-index trees of a tree of leaves stacked on a leading axis
    (views, in order). One unbind per stacked leaf: its backward stacks
    the per-index grads in one pass (an index per layer would add a
    full-size zero-filled gradient per layer)."""
    stacked, treedef = tree_flatten(tree)
    per_index = [x.unbind(0) for x in stacked]
    for j in range(stacked[0].shape[0]):
        yield tree_unflatten(treedef, [u[j] for u in per_index])


def decoder_layers(params):
    """The stack's layers in order: yields ``(layer, sub)``, ``sub`` the
    ``{attn|ssm[, mlp]}`` params of one layer (views of the stacked
    leaves)."""
    period = len(params["blocks"])
    for j, superblock in enumerate(stacked_layers(params["blocks"])):
        for i in range(period):
            yield j * period + i, superblock[f"sub{i}"]


def _mixer(sub, h, cfg, *, positions, mrope_pos=None, collect_cache=False):
    """One layer's mixer (attention or SSM): (h, its cache entry or
    None)."""
    if "attn" in sub:
        h, (k, v) = attn_sublayer(sub["attn"], h, cfg, positions=positions,
                                  mrope_pos=mrope_pos,
                                  window=cfg.sliding_window)
        return h, ({"k": k, "v": v} if collect_cache else None)
    h, st = ssm_sublayer(sub["ssm"], h, cfg, return_state=collect_cache)
    return h, ({"state": st[0], "conv_tail": st[1]} if collect_cache
               else None)


def decoder_layer(sub, h, cfg, *, positions, use_moe, mrope_pos=None):
    """One layer: its mixer (attention or SSM), then its MLP (or MoE, with
    ``use_moe``) if it has one. Returns (h, aux), aux None without an
    MoE."""
    h, _ = _mixer(sub, h, cfg, positions=positions, mrope_pos=mrope_pos)
    if "mlp" in sub:
        return mlp_sublayer(sub["mlp"], h, cfg, use_moe=use_moe)
    return h, None


def decoder_forward(params, h, cfg, *, positions, mrope_pos=None,
                    collect_cache=False):
    """Run the stack over hidden states ``h`` (B, S, d). Returns
    (h, aux_loss, cache|None); with ``collect_cache`` the cache holds each
    layer's K/V (attention) or final state and conv tail (SSM), stacked
    ``(n_super, ...)`` under ``sub{i}`` as the reference's are.
    ``mrope_pos`` (3, B, S): the M-RoPE ids (``cfg.mrope``). Without a
    cache each super-block (its ``period`` sub-layers) is one
    ``remat_block`` call; the cache branch serves prefill, under
    ``inference_mode``."""
    if not collect_cache:
        kinds = layer_kinds(cfg)[:len(params["blocks"])]

        def superblock(h, bp, dc, ic):
            """One super-block's sub-layers: (h, the sum of their MoE aux
            losses, None without an MoE)."""
            del dc
            aux_total = None
            for i, (_, use_moe) in enumerate(kinds):
                h, aux = decoder_layer(bp[f"sub{i}"], h, cfg,
                                       positions=ic["positions"],
                                       use_moe=use_moe,
                                       mrope_pos=ic["mrope"])
                if aux is not None:
                    aux_total = aux if aux_total is None else aux_total + aux
            return h, aux_total

        block = remat_block(superblock)
        ic = {"positions": positions, "mrope": mrope_pos}
        aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
        for bp in stacked_layers(params["blocks"]):
            h, aux = block(h, bp, {}, ic)
            if aux is not None:
                aux_total = aux_total + aux
        return h, aux_total, None
    entries = []
    for layer, sub in decoder_layers(params):
        h, entry = _mixer(sub, h, cfg, positions=positions,
                          mrope_pos=mrope_pos, collect_cache=True)
        entries.append(entry)
        if "mlp" in sub:
            h, _ = mlp_sublayer(sub["mlp"], h, cfg,
                                use_moe=cfg.is_moe_layer(layer))
    period = len(params["blocks"])
    cache = {f"sub{i}": {k: torch.stack([e[k] for e in entries[i::period]])
                         for k in entries[i]}
             for i in range(period)}
    return h, torch.zeros((), dtype=torch.float32, device=h.device), cache


def decoder_decode_step(params, h, cfg, cache, *, position, window):
    """One-token step through the stack. h: (B, 1, d); cache stacked
    (n_super, ...) under ``sub{i}``, written in place (the reference's
    jitted step donates it), but for a bf16 SSM state, which the first
    step replaces by its float32 stack (:func:`ssm_sublayer_decode`).
    Returns (h, cache)."""
    period = len(params["blocks"])
    promoted = {}  # sub → the layers' widened SSM states (first step)
    for layer, sub in decoder_layers(params):
        j, i = divmod(layer, period)
        c = {k: v[j] for k, v in cache[f"sub{i}"].items()}
        if "attn" in sub:
            h, _ = attn_sublayer_decode(sub["attn"], h, cfg, c,
                                        position=position, window=window)
        else:
            h, _ = ssm_sublayer_decode(sub["ssm"], h, cfg, c)
            if c["state"].dtype != cache[f"sub{i}"]["state"].dtype:
                promoted.setdefault(f"sub{i}", []).append(c["state"])
        if "mlp" in sub:
            h, _ = mlp_sublayer(sub["mlp"], h, cfg,
                                use_moe=cfg.is_moe_layer(layer))
    with torch.inference_mode(False):  # a normal tensor, as allocated
        for name, states in promoted.items():
            cache[name]["state"] = torch.stack(states)
    return h, cache


def decoder_cache_specs(cfg, B, seq_len, window, dtype=None):
    kinds = layer_kinds(cfg)[:_superblock_period(cfg)]
    prefix = (cfg.num_layers // len(kinds),)
    out = {}
    for i, (mixer, _) in enumerate(kinds):
        if mixer == "attn":
            out[f"sub{i}"] = attn_cache_specs(cfg, B, seq_len, window,
                                              prefix, dtype)
        else:
            out[f"sub{i}"] = ssm_cache_specs(cfg, B, prefix, dtype)
    return out


def alloc_cache(specs, *, device):
    """Zero tensors for a cache-spec tree, on ``device`` (no default: the
    caller names the device)."""
    device = torch.device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device), specs)
