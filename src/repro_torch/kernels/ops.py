"""Kernel dispatch by the tensor's device.

A CPU tensor goes to the plain PyTorch version (``repro_torch.kernels.ref``).
A CUDA tensor launches the hand-written kernel, and a kernel that fails to
build or launch raises: there is no fall back to the plain version for a
CUDA tensor. Any other device is an error.
"""
from __future__ import annotations

import torch

from repro_torch.core.pytree import tree_map
from repro_torch.kernels import flash_attention as _flash_kernel
from repro_torch.kernels import gossip_mix as _gossip_mix_kernel
from repro_torch.kernels import quantize as _quant_kernel
from repro_torch.kernels import rmsnorm as _rmsnorm_kernel
from repro_torch.kernels import ssd_scan as _ssd_kernel
from repro_torch.kernels.ref import (dequant_mix_ref, flash_attention_bwd_ref,
                                     flash_attention_ref, gossip_mix_ref,
                                     quantize_plane_ref, rmsnorm_ref,
                                     ssd_scan_ref)


def gossip_mix(x: torch.Tensor, x_recv: torch.Tensor, upd, alpha, beta,
               out=None) -> torch.Tensor:
    """``α·x + β·x_recv (+ upd)`` in float32, stored in ``x.dtype``; see
    :func:`repro_torch.kernels.gossip_mix.gossip_mix`."""
    if x.device.type == "cpu":
        return gossip_mix_ref(x, x_recv, upd, alpha, beta, out=out)
    if x.device.type == "cuda":
        return _gossip_mix_kernel.gossip_mix(x, x_recv, upd, alpha, beta,
                                             out=out)
    raise ValueError(f"gossip_mix: no kernel for device {x.device}")


def gossip_mix_tree(params, recv, updates, alpha, beta):
    """:func:`gossip_mix` on each leaf of three trees of one structure (per
    layer group, the paper's layer-wise granularity)."""
    return tree_map(lambda x, r, u: gossip_mix(x, r, u, alpha, beta),
                    params, recv, updates)


def quantize_plane(x: torch.Tensor, resid=None, *, out_q=None, out_s=None,
                   out_resid=None):
    """int8 error-feedback quantization ``(q, scales, resid')``; see
    :func:`repro_torch.kernels.quantize.quantize_plane`."""
    kw = dict(out_q=out_q, out_s=out_s, out_resid=out_resid)
    if x.device.type == "cpu":
        return quantize_plane_ref(x, resid, **kw)
    if x.device.type == "cuda":
        return _quant_kernel.quantize_plane(x, resid, **kw)
    raise ValueError(f"quantize_plane: no kernel for device {x.device}")


def dequant_mix(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor, upd,
                alpha, beta, out=None) -> torch.Tensor:
    """``α·x + β·(q·s) (+ upd)`` in float32, stored in ``x.dtype``; see
    :func:`repro_torch.kernels.quantize.dequant_mix`."""
    if x.device.type == "cpu":
        return dequant_mix_ref(x, q, scales, upd, alpha, beta, out=out)
    if x.device.type == "cuda":
        return _quant_kernel.dequant_mix(x, q, scales, upd, alpha, beta,
                                         out=out)
    raise ValueError(f"dequant_mix: no kernel for device {x.device}")


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-5,
            tile_rows: int = 256) -> torch.Tensor:
    """``x·rsqrt(mean(x²)+eps)·γ`` over the last axis, f32 statistics,
    stored in ``x.dtype``; see :func:`repro_torch.kernels.rmsnorm.rmsnorm`.
    ``tile_rows`` is accepted for the JAX signature and ignored: the kernel
    takes one row a warp and needs no row tile."""
    del tile_rows
    if x.device.type == "cpu":
        return rmsnorm_ref(x, gamma, eps)
    if x.device.type == "cuda":
        return _rmsnorm_kernel.rmsnorm(x, gamma, eps=eps)
    raise ValueError(f"rmsnorm: no kernel for device {x.device}")


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 128) -> torch.Tensor:
    """The Mamba2 SSD chunked scan: x ``(B, H, S, P)``, dt ``(B, H, S)``,
    A ``(H,)``, Bm/Cm ``(B, S, N)`` → y ``(B, H, S, P)``; see
    :func:`repro_torch.kernels.ssd_scan.ssd_scan`."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
    if x.device.type == "cuda":
        return _ssd_kernel.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    raise ValueError(f"ssd_scan: no kernel for device {x.device}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Flash forward ``(o, lse)``; see
    :func:`repro_torch.kernels.flash_attention.flash_attention`."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type == "cuda":
        return _flash_kernel.flash_attention(q, k, v, causal=causal,
                                             window=window)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0):
    """Flash backward ``(dq, dk, dv)``; see
    :func:`repro_torch.kernels.flash_attention.flash_attention_bwd`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    if q.device.type == "cuda":
        return _flash_kernel.flash_attention_bwd(q, k, v, o, lse, do,
                                                 causal=causal, window=window)
    raise ValueError(f"flash_attention_bwd: no kernel for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention, the counterpart of the reference's
    ``custom_vjp`` ``flash_attention_trainable``: the forward saves q, k, v,
    o and the log-sum-exp, the backward recomputes P from them. Both go
    through the dispatch above (kernels on CUDA, plain versions on the
    CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_trainable(q, k, v, *, causal: bool = True,
                              window: int = 0) -> torch.Tensor:
    """Attention with a flash backward; q ``(B, Hq, Sq, D)``, k and v
    ``(B, Hkv, Sk, D)`` → o ``(B, Hq, Sq, D)``."""
    return FlashAttention.apply(q, k, v, causal, window)


__all__ = ["gossip_mix", "gossip_mix_tree", "quantize_plane", "dequant_mix",
           "rmsnorm", "ssd_scan", "flash_attention", "flash_attention_bwd",
           "flash_attention_trainable"]
