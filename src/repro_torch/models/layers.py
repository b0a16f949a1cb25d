"""Shared neural-net building blocks (port of ``repro/models/layers.py``,
the decoder parts).

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

from repro_torch.core.pytree import (tree_flatten_with_path, tree_leaves,
                                    tree_map, tree_unflatten)
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


def abstract_params(specs, dtype=torch.float32):
    """The spec tree as tensors on the ``meta`` device: shapes and dtypes,
    nothing allocated (the JAX package's ``ShapeDtypeStruct`` tree)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype or dtype,
                                          device="meta"), specs)


def logical_axes(specs):
    """The tree of each parameter's logical axis names."""
    return tree_map(lambda s: s.axes, specs)


def param_count(params) -> int:
    """Elements over every leaf of a parameter tree (tensors, meta tensors
    or specs)."""
    return sum(int(np.prod(x.shape, dtype=np.int64))
               for x in tree_leaves(params))


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


# (name, ..., device) -> a constant table (inverse frequencies, sinusoids)
# on that device. A copy from pageable host memory waits for the device's
# queue, so a copy per call would stall the host at every attention layer;
# each device gets one.
_DEVICE_TABLES = {}


def _device_table(key, make, device: torch.device) -> torch.Tensor:
    """The table ``make()`` (a float32 numpy array) on ``device``, copied
    there once per ``key`` and device."""
    key = key + (device,)
    if key not in _DEVICE_TABLES:
        with torch.inference_mode(False):  # usable by training too
            t = torch.from_numpy(make()).to(device)
        if t.device.type == "cuda":
            # visible to every stream before first use
            torch.cuda.current_stream(t.device).synchronize()
        _DEVICE_TABLES[key] = t
    return _DEVICE_TABLES[key]


def _rope_inv(rot_dim: int, inv: np.ndarray, theta: float,
              device: torch.device) -> torch.Tensor:
    return _device_table(("rope", rot_dim, theta), lambda: inv, device)


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
    return _rotate(x, ang, rot_dim)


def _rotate(x, ang, rot_dim):
    """The rotation of x's first ``rot_dim`` features by angles ``ang``
    (..., S, rot_dim/2), in float32, stored in x's dtype."""
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = x_rot[..., : rot_dim // 2], x_rot[..., rot_dim // 2:]
    out1 = x1.to(torch.float32) * cos - x2.to(torch.float32) * sin
    out2 = x2.to(torch.float32) * cos + x1.to(torch.float32) * sin
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype), x_pass], dim=-1)


# M-RoPE (qwen2-vl): the half-dim frequencies split into 3 sections fed by
# the (t, h, w) position ids
_MROPE_FRACS = (0.25, 0.375, 0.375)


def mrope_sections(head_dim: int) -> list:
    half = head_dim // 2
    secs = [int(half * f) for f in _MROPE_FRACS]
    secs[-1] = half - secs[0] - secs[1]
    return secs


def apply_mrope(x, positions3, *, theta=1e6):
    """x: (B, S, H, D); positions3: (3, B, S) temporal/height/width ids.
    Frequency i of the half dimension turns with the ids of its section's
    axis; the inverse frequencies are standard RoPE's over all of D."""
    head_dim = x.shape[-1]
    rot_dim, inv = _rope_freqs(head_dim, 1.0, theta)
    inv = _rope_inv(rot_dim, inv, theta, x.device)
    pos = torch.cat([positions3[i][..., None].expand(
        *positions3.shape[1:], n) for i, n in enumerate(
            mrope_sections(head_dim))], dim=-1)  # (B, S, half)
    return _rotate(x, pos.to(torch.float32) * inv, rot_dim)


def _sinusoid_table(seq_len: int, d_model: int) -> np.ndarray:
    pos = np.arange(seq_len, dtype=np.float32)[:, None]
    dim = np.arange(0, d_model, 2, dtype=np.float32)[None, :]
    ang = pos / np.power(10000.0, dim / d_model)
    out = np.zeros((seq_len, d_model), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


def sinusoidal_positions(seq_len: int, d_model: int, *,
                         device) -> torch.Tensor:
    """(seq_len, d_model) float32 sinusoids (sin at even, cos at odd
    features), computed in numpy as the reference does and kept on
    ``device``."""
    return _device_table(("sinusoid", seq_len, d_model),
                         lambda: _sinusoid_table(seq_len, d_model),
                         torch.device(device))


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
    out = {
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
    if cfg.qk_norm:
        out["q_norm"] = ParamSpec(L + (hd,), La + ("hd",), init="ones")
        out["k_norm"] = ParamSpec(L + (hd,), La + ("hd",), init="ones")
    return out


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
