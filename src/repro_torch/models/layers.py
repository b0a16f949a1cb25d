"""Shared neural-net building blocks (port of ``repro/models/layers.py``,
the dense-decoder parts).

Parameters are declared as ``ParamSpec`` trees (shape + logical axes +
initializer); ``init_params`` instantiates them with a ``torch.Generator``.
Layouts follow the JAX package: activations ``(B, S, d)``, attention heads
``(B, S, H, D)``, so the parity tests compare like with like.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.pytree import tree_flatten_with_path, tree_unflatten

# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamSpec:
    """Declarative parameter: shape, logical axes, initializer."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | scaled
    scale: float = 0.02
    dtype: Any = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def _path_str(path) -> str:
    return "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                    for e in path)


def init_params(specs, *, seed: int = 0, dtype=torch.float32, device=None):
    """Instantiate a ParamSpec tree into tensors on ``device``.

    Each leaf draws from its own ``torch.Generator``, seeded from ``seed``
    and a CRC32 of the leaf's path, so a leaf's values do not depend on the
    other leaves or on the process (the JAX package's init hashes paths with
    Python's salted ``hash``; the two inits share distributions, not
    numbers)."""
    flat, treedef = tree_flatten_with_path(specs)
    device = torch.device(device if device is not None else "cpu")
    leaves = []
    for path, spec in flat:
        dt = spec.dtype or dtype
        if spec.init == "zeros":
            leaves.append(torch.zeros(spec.shape, dtype=dt, device=device))
            continue
        if spec.init == "ones":
            leaves.append(torch.ones(spec.shape, dtype=dt, device=device))
            continue
        gen = torch.Generator(device=device)
        gen.manual_seed((seed * 1_000_003
                         + zlib.crc32(_path_str(path).encode())) % 2**63)
        w = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                        device=device) * spec.scale
        leaves.append(w.to(dt))
    return tree_unflatten(treedef, leaves)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x, gamma, eps=1e-5):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.to(torch.float32)).to(x.dtype)


def rmsnorm_spec(d: int, axis: str = "embed") -> ParamSpec:
    return ParamSpec((d,), (axis,), init="ones")


# ---------------------------------------------------------------------------
# Rotary position embeddings (standard and partial)
# ---------------------------------------------------------------------------


def _rope_freqs(head_dim: int, fraction: float, theta: float):
    rot_dim = int(head_dim * fraction)
    rot_dim -= rot_dim % 2
    inv = 1.0 / (theta ** (np.arange(0, rot_dim, 2, dtype=np.float32)
                           / rot_dim))
    return rot_dim, inv  # (rot_dim//2,) float32


def apply_rope(x, positions, *, theta=1e4, fraction=1.0):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    head_dim = x.shape[-1]
    if theta <= 0:
        return x
    rot_dim, inv = _rope_freqs(head_dim, fraction, theta)
    if rot_dim == 0:
        return x
    inv = torch.from_numpy(inv).to(x.device)
    ang = positions[..., :, None].to(torch.float32) * inv  # (..., S, rd/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = x_rot[..., : rot_dim // 2], x_rot[..., rot_dim // 2:]
    out1 = x1.to(torch.float32) * cos - x2.to(torch.float32) * sin
    out2 = x2.to(torch.float32) * cos + x1.to(torch.float32) * sin
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# Attention (GQA, full sequence, plain torch)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def attention_specs(cfg, prefix_layers: Tuple[int, ...] = ()):
    """Projection specs for one attention sub-layer (optionally stacked)."""
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L = prefix_layers
    La = tuple("layers" for _ in L)
    sc = 0.02
    return {
        "wq": ParamSpec(L + (d, hq, hd), La + ("embed", "heads", "hd"),
                        scale=sc),
        "wk": ParamSpec(L + (d, hkv, hd), La + ("embed", "kv", "hd"),
                        scale=sc),
        "wv": ParamSpec(L + (d, hkv, hd), La + ("embed", "kv", "hd"),
                        scale=sc),
        "wo": ParamSpec(L + (hq, hd, d), La + ("heads", "hd", "embed"),
                        init="scaled",
                        scale=sc / np.sqrt(max(2 * cfg.num_layers, 1))),
    }


def attention(q, k, v, *, q_positions, k_positions, causal=True, window=0):
    """Full-sequence attention: the function ``flash_attention_jnp``
    computes, written plainly (f32 scores, one softmax; autograd supplies
    the backward).

    q: (B, Sq, Hq, D);  k, v: (B, Sk, Hkv, D).
    positions: (B, Sq) / (B, Sk) absolute token indices (negative = invalid).
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = D ** -0.5
    qh = (q * scale).reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)
    kh = k.permute(0, 2, 1, 3)  # (B, Hkv, Sk, D)
    vh = v.permute(0, 2, 1, 3)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qh.to(torch.float32),
                     kh.to(torch.float32))
    kp = k_positions[:, None, None, None, :]
    qp = q_positions[:, None, None, :, None]
    mask = kp >= 0
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & ((qp - kp) < window)
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype,
                                         device=s.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype), vh)
    return (out.to(torch.float32).permute(0, 3, 1, 2, 4)
            .reshape(B, Sq, Hq, D).to(q.dtype))


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_specs(cfg, d_ff: int, prefix_layers: Tuple[int, ...] = ()):
    d = cfg.d_model
    L = prefix_layers
    La = tuple("layers" for _ in L)
    return {
        "wi_gate": ParamSpec(L + (d, d_ff), La + ("embed", "ffn")),
        "wi_up": ParamSpec(L + (d, d_ff), La + ("embed", "ffn")),
        "wo": ParamSpec(L + (d_ff, d), La + ("ffn", "embed"), init="scaled",
                        scale=0.02 / np.sqrt(max(2 * cfg.num_layers, 1))),
    }


def mlp_apply(p, x):
    h = F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_specs(cfg):
    out = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                            scale=0.02)}
    if not cfg.tie_embeddings:
        out["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                   ("embed", "vocab"), scale=0.02)
    return out


def embed_apply(p, tokens):
    return F.embedding(tokens.long(), p["tok"])


def unembed_apply(p, h, tie: bool):
    """Logits in float32."""
    if tie:
        return h.to(torch.float32) @ p["tok"].to(torch.float32).T
    return h.to(torch.float32) @ p["unembed"].to(torch.float32)


def cross_entropy(logits, labels):
    """logits: (..., V) f32; labels: (...) int. Mean over all positions."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)
