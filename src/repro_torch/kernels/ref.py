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
