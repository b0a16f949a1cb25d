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
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref, rmsnorm_ref

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
    """Instantiate a ParamSpec tree into tensors on ``device`` (``None`` →
    CUDA, raising without it, as every entry point of the port).

    Each leaf draws from its own ``torch.Generator``, seeded from ``seed``
    and a CRC32 of the leaf's path, so a leaf's values do not depend on the
    other leaves or on the process (the JAX package's init hashes paths with
    Python's salted ``hash``; the two inits share distributions, not
    numbers)."""
    flat, treedef = tree_flatten_with_path(specs)
    device = resolve_device(device)
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
    """The model's norm, plain PyTorch on every device (the reference's
    models call the plain norm too, never the fused kernel)."""
    return rmsnorm_ref(x, gamma, eps)


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


# (rot_dim, theta, device) -> the inverse frequencies on that device. A copy
# from pageable host memory waits for the device's queue, so a copy per call
# would stall the host at every attention layer; each device gets one.
_ROPE_INV = {}


def _rope_inv(rot_dim: int, inv: np.ndarray, theta: float,
              device: torch.device) -> torch.Tensor:
    key = (rot_dim, theta, device)
    if key not in _ROPE_INV:
        with torch.inference_mode(False):  # usable by training too
            t = torch.from_numpy(inv).to(device)
        if t.device.type == "cuda":
            # visible to every stream before first use
            torch.cuda.current_stream(t.device).synchronize()
        _ROPE_INV[key] = t
    return _ROPE_INV[key]


def apply_rope(x, positions, *, theta=1e4, fraction=1.0):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    head_dim = x.shape[-1]
    if theta <= 0:
        return x
    rot_dim, inv = _rope_freqs(head_dim, fraction, theta)
    if rot_dim == 0:
        return x
    inv = _rope_inv(rot_dim, inv, theta, x.device)
    ang = positions[..., :, None].to(torch.float32) * inv  # (..., S, rd/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = x_rot[..., : rot_dim // 2], x_rot[..., rot_dim // 2:]
    out1 = x1.to(torch.float32) * cos - x2.to(torch.float32) * sin
    out2 = x2.to(torch.float32) * cos + x1.to(torch.float32) * sin
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# Attention (GQA, full sequence)
# ---------------------------------------------------------------------------

# When True (the default), full-sequence attention goes through the flash
# kernels (``ops.flash_attention_trainable``: the CUDA C++ forward and
# backward on a CUDA tensor, their plain versions on the CPU); when False,
# through the plain ``ref.attention_ref`` with an autograd backward, on any
# device. The reference's selector of the same name. Only the tests and
# chip_smoke.py (its route phase, and --profile's comparison) set it False,
# to hold the two routes against each other.
USE_PALLAS = True


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


def attention(q, k, v, *, causal=True, window=0):
    """Full-sequence attention: the function ``flash_attention_jnp``
    computes, with positions derived from indices as the reference's kernel
    route derives them (every caller's positions are ``arange(S)``).

    q: (B, Sq, Hq, D);  k, v: (B, Sk, Hkv, D), passed on as (B, H, S, D)
    views (the kernel route reads them through their strides, no copies).
    ``USE_PALLAS`` selects the route.
    """
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    if USE_PALLAS:
        out = ops.flash_attention_trainable(qh, kh, vh, causal=causal,
                                            window=window)
    else:
        out = attention_ref(qh, kh, vh, causal=causal, window=window)
    return out.transpose(1, 2)


NEG_INF = -1e30


def decode_attention(q, k_cache, v_cache, *, q_position, k_positions,
                     window=0, causal=True):
    """Single-token attention over a (possibly ring-buffered) cache, in
    plain PyTorch on every device (the reference computes it outside any
    kernel too).

    q: (B, 1, Hq, D); caches: (B, Sc, Hkv, D); q_position: (B,);
    k_positions: (B, Sc) absolute positions per slot (negative = empty).
    Scores and the PV product are summed in float32; the output is in q's
    dtype.
    """
    B, _, Hq, D = q.shape
    _, Sc, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    scale = D ** -0.5
    qh = (q * scale).reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bshd->bhgs", qh.to(torch.float32),
                     k_cache.to(torch.float32))
    mask = k_positions >= 0
    if causal:
        mask = mask & (k_positions <= q_position[:, None])
    if window > 0:
        mask = mask & ((q_position[:, None] - k_positions) < window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd",
                       p.to(v_cache.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(B, 1, Hq, D).to(q.dtype)


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
