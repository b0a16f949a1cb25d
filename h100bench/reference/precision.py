"""Roundings for the reference's matrix products.

``rounder("float32")`` is the reference itself (products in float32 with
TF32 off). The others are the low-precision controls that the correctness
limits must reject. Each rounds both operands of every product to the
format and multiplies in float32, which is what the format's tensor-core
products compute, and rounds the gradient that flows back into the product
too, so that the backward pass's products take rounded operands as well.
``tf32``: 10 mantissa bits, round to nearest even, both ways. FP8, as FP8
training runs it: operands in e4m3 and gradients in e5m2, each scaled per
tensor so that its largest magnitude maps to the format's largest finite
value.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


def _tf32(x):
    bits = x.contiguous().view(torch.int32)
    bias = 0x0FFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def _fp8(fmt, top):
    def round_(x):
        scale = x.abs().amax().clamp(min=1e-30) / top
        return (x / scale).to(fmt).to(torch.float32) * scale
    return round_


class _Round(torch.autograd.Function):
    """Rounds the forward value with ``fwd`` and the gradient with ``bwd``
    (either may be None: passed through)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return x.view_as(x) if fwd is None else fwd(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.bwd is None else ctx.bwd(g)), None, None


class Rounder(NamedTuple):
    operand: Callable  # applied to each operand of a product
    result: Callable   # applied to its result: rounds the gradient back


def _make(op, grad) -> Rounder:
    return Rounder(lambda x: _Round.apply(x, op, None),
                   lambda y: _Round.apply(y, None, grad))


_IDENTITY = Rounder(lambda x: x, lambda y: y)
ROUNDERS = {
    "float32": lambda: _IDENTITY,
    "tf32": lambda: _make(_tf32, _tf32),
    "float8": lambda: _make(_fp8(torch.float8_e4m3fn, 448.0),
                            _fp8(torch.float8_e5m2, 57344.0)),
}

# the control of each configured dtype: the nearest precision below it
CONTROL = {"float32": "tf32", "bfloat16": "float8"}


def rounder(name: str) -> Rounder:
    if name not in ROUNDERS:
        raise ValueError(f"unknown precision {name!r}")
    return ROUNDERS[name]()
