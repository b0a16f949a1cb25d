"""Kernel dispatch by the tensor's device.

A CPU tensor goes to the plain PyTorch version (``repro_torch.kernels.ref``).
A CUDA tensor launches the hand-written kernel, and a kernel that fails to
build or launch raises: there is no fall back to the plain version for a
CUDA tensor. Any other device is an error.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gossip_mix as _gossip_mix_kernel
from repro_torch.kernels.ref import gossip_mix_ref


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


__all__ = ["gossip_mix"]
