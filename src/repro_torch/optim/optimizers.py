"""Functional optimizers on dicts of plane buffers (port of
``repro/optim/optimizers.py``).

An ``Optimizer`` is a pair of plain functions:
  init(params) -> state
  update(grads, state, params, lr) -> (updates, state)
``params``/``grads`` are dicts of tensors, normally the stacked ``(M, n)``
layer-group buffers of the flat plane; every rule is elementwise, so the
worker axis needs no ``vmap``. Updates are descent directions already scaled
by ``lr``: apply with ``apply_updates``. ``lr`` is a Python float. Nothing
here uses ``torch.optim``: the fused gossip route needs the update deltas
themselves, not parameters mutated in place.

``update`` advances the optimizer state IN PLACE and returns it: the state
is consumed, as the JAX package's jitted step donates it, which saves one
plane-sized buffer per state slot. The arithmetic and its rounding order
are the JAX package's.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.pytree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params, lr) -> (updates, state)


def apply_updates(params, updates):
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


def _wd_term(weight_decay):
    if weight_decay == 0.0:
        return lambda g, p: g
    return lambda g, p: g + weight_decay * p.to(g.dtype)


def sgd(weight_decay: float = 0.0) -> Optimizer:
    wd = _wd_term(weight_decay)

    def init(params):
        return ()

    def update(grads, state, params, lr):
        return {k: -lr * wd(g, params[k]) for k, g in grads.items()}, state

    return Optimizer(init, update)


def momentum(beta: float = 0.9, weight_decay: float = 0.0,
             nesterov: bool = False, state_dtype=None) -> Optimizer:
    wd = _wd_term(weight_decay)

    def init(params):
        return {k: torch.zeros_like(p, dtype=state_dtype or p.dtype)
                for k, p in params.items()}

    def update(grads, state, params, lr):
        g = {k: wd(gg, params[k]) for k, gg in grads.items()}
        for k, m in state.items():
            m.mul_(beta).add_(g[k].to(m.dtype))
        if nesterov:
            upd = {k: -lr * (beta * m + g[k].to(m.dtype))
                   for k, m in state.items()}
        else:
            upd = {k: -lr * m for k, m in state.items()}
        return upd, state

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, state_dtype=torch.float32) -> Optimizer:
    """The step count is one shared 0-d int32 tensor: all workers of the
    stacked plane step together (the JAX package vmaps one count per
    worker, all equal)."""

    def init(params):
        any_p = next(iter(params.values()))
        return {"mu": {k: torch.zeros_like(p, dtype=state_dtype)
                       for k, p in params.items()},
                "nu": {k: torch.zeros_like(p, dtype=state_dtype)
                       for k, p in params.items()},
                "count": torch.zeros((), dtype=torch.int32,
                                     device=any_p.device)}

    def update(grads, state, params, lr):
        count = state["count"] + 1
        mu, nu = state["mu"], state["nu"]
        for k, m in mu.items():
            m.mul_(b1).add_((1 - b1) * grads[k].to(m.dtype))
        for k, v in nu.items():
            v.mul_(b2).add_((1 - b2) * torch.square(grads[k].to(v.dtype)))
        c1 = 1 - b1 ** count.to(torch.float32)
        c2 = 1 - b2 ** count.to(torch.float32)

        def upd(m, v, p):
            mhat = m / c1
            vhat = v / c2
            return -lr * (mhat / (torch.sqrt(vhat) + eps)
                          + weight_decay * p.to(m.dtype))

        updates = {k: upd(mu[k], nu[k], params[k]) for k in mu}
        return updates, {"mu": mu, "nu": nu, "count": count}

    return Optimizer(init, update)


def get_optimizer(name: str, **kw) -> Optimizer:
    return {"sgd": sgd, "momentum": momentum, "adamw": adamw}[name](**kw)


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm of every leaf of ``tree`` together (a 0-d
    tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """``(clipped, n)``: every leaf scaled by ``min(1, max_norm / max(n,
    1e-9))``, the scale cast to the leaf's dtype, ``n`` the global norm
    before clipping."""
    n = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), n
