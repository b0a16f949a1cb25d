"""Learning-rate schedules (port of ``repro/optim/schedules.py``).

A schedule maps the step index to a Python float, computed in float32 as
the JAX package computes it, so an update ``-lr·m`` rounds the same way and
stepping never enqueues device work.
"""
from __future__ import annotations

import numpy as np

_f32 = np.float32


def constant(lr: float):
    return lambda step: float(_f32(lr))


def cosine(lr: float, t_max: int, lr_min: float = 0.0):
    def fn(step):
        frac = np.clip(_f32(step) / _f32(max(t_max, 1)), _f32(0.0),
                       _f32(1.0))
        return float(_f32(lr_min) + _f32(0.5) * _f32(lr - lr_min)
                     * (_f32(1.0) + np.cos(_f32(np.pi) * frac)))
    return fn


def linear_warmup_cosine(lr: float, warmup: int, t_max: int,
                         warmup_lr: float = 0.0, lr_min: float = 0.0):
    cos = cosine(lr, max(t_max - warmup, 1), lr_min)

    def fn(step):
        s = _f32(step)
        if s < warmup:
            return float(_f32(warmup_lr) + _f32(lr - warmup_lr) * s
                         / _f32(max(warmup, 1)))
        return cos(s - _f32(warmup))
    return fn
