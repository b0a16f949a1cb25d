"""Plain PyTorch versions of the port's kernels: the CPU path and the oracle
the CUDA kernels are held against (counterpart of ``repro/kernels/ref.py``).
"""
from __future__ import annotations

import torch


def row_scalars(a, x: torch.Tensor) -> torch.Tensor:
    """Per-row mix coefficient as a float32 tensor on ``x``'s device.

    A 1-D tensor of shape ``(M,)`` is one coefficient per worker row of a
    stacked ``(M, ...)`` buffer; a Python number or 0-d tensor is one
    coefficient for the whole of ``x`` (returned with shape ``(1,)``)."""
    a = torch.as_tensor(a, dtype=torch.float32, device=x.device)
    if a.dim() == 0:
        return a.reshape(1)
    if a.dim() != 1 or x.dim() == 0 or a.shape[0] != x.shape[0]:
        raise ValueError(f"per-worker coefficients of shape {tuple(a.shape)} "
                         f"do not match buffer rows {tuple(x.shape[:1])}")
    return a


def gossip_mix_ref(x, x_recv, upd, alpha, beta, out=None):
    """``α·x + β·x_recv (+ upd)`` in float32, stored in ``x.dtype``.

    ``alpha``/``beta``: scalars, or ``(M,)`` per-worker coefficients
    broadcast over the rows of a stacked ``(M, n)`` buffer. ``upd=None`` is
    the pure-mix variant. ``out`` (may be ``x`` itself) receives the
    result."""
    bshape = (-1,) + (1,) * (x.dim() - 1) if x.dim() else ()
    a = row_scalars(alpha, x).reshape(bshape)
    b = row_scalars(beta, x).reshape(bshape)
    res = a * x.to(torch.float32) + b * x_recv.to(torch.float32)
    if upd is not None:
        res = res + upd.to(torch.float32)
    if out is None:
        return res.to(x.dtype)
    return out.copy_(res)


NEG_INF = -1e30


def _mask(Sq: int, Sk: int, causal: bool, window: int, device):
    """(Sq, Sk) bool: key k is visible to query q. Positions are the row
    indices, as the flash kernels derive them from their tile offsets."""
    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & ((qp - kp) < window)
    return mask


def _scores(q, k, causal, window):
    """Masked f32 scores ``(B, Hkv, G, Sq, Sk)`` of ``q·scale`` against k."""
    B, Hq, Sq, d = q.shape
    _, Hkv, Sk, _ = k.shape
    qh = q.reshape(B, Hkv, Hq // Hkv, Sq, d).to(torch.float32) * d ** -0.5
    s = torch.einsum("bhgqd,bhkd->bhgqk", qh, k.to(torch.float32))
    return torch.where(_mask(Sq, Sk, causal, window, q.device), s,
                       torch.full((), NEG_INF, dtype=s.dtype, device=s.device))


def attention_ref(q, k, v, *, causal=True, window=0):
    """q: (B, Hq, Sq, d); k, v: (B, Hkv, Sk, d). Naive softmax attention,
    the counterpart of ``repro/kernels/ref.py::attention_ref``."""
    B, Hq, Sq, d = q.shape
    p = torch.softmax(_scores(q, k, causal, window), dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    return o.reshape(B, Hq, Sq, d).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """The flash forward's function, plainly: ``(o, lse)`` with o in
    ``q.dtype`` and the f32 log-sum-exp ``(B, Hq, Sq)`` the backward
    recomputes P from. Layouts as :func:`attention_ref`."""
    B, Hq, Sq, d = q.shape
    s = _scores(q, k, causal, window)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    return (o.reshape(B, Hq, Sq, d).to(q.dtype),
            lse.reshape(B, Hq, Sq))


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=0):
    """The flash backward's function, with the Pallas bodies' formulas:
    ``P = exp(s − lse)``, ``delta = rowsum(do·o)``, ``dS = P·(dP − delta)``,
    ``dq = scale·dS·k``, ``dk = dSᵀ·(q·scale)`` and ``dv = Pᵀ·do``, each
    summed over the q heads of a kv group in f32. Returns (dq, dk, dv) in
    the dtypes of q, k and v."""
    B, Hq, Sq, d = q.shape
    _, Hkv, Sk, _ = k.shape
    G = Hq // Hkv
    scale = d ** -0.5

    def grouped(x):
        return x.reshape(B, Hkv, G, Sq, -1).to(torch.float32)

    p = torch.exp(_scores(q, k, causal, window) - grouped(lse))
    do_f = grouped(do)
    delta = (do_f * grouped(o)).sum(-1, keepdim=True)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", do_f, v.to(torch.float32))
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.to(torch.float32)) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, grouped(q) * scale)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, do_f)
    return (dq.reshape(B, Hq, Sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
