"""Diagnostics for the paper's theory: drift, gradient bias, elastic bound;
port of ``repro/core/drift.py`` on ``torch.autograd.grad``.

* ``disagreement`` (in repro_torch.core.api): mean_i ‖x_i − x̄‖.
* ``gradient_bias``: ‖g(x̂) − g(x̃)‖ — the bias Lemma 6.1 bounds:
  E‖b‖² ≤ 4 K_b² η² B².
* ``estimate_lipschitz``: empirical K_b via random perturbations.
* ``elastic_constant``: empirical B̂ from E‖x̄ − x_i‖² ≤ η²B².

Together: bias² ≤ 4 · K̂² · η² · B̂² (``lemma61_bound``).
"""
from __future__ import annotations

from typing import Callable, List

import torch

from repro_torch.core.api import consensus
from repro_torch.core.pytree import (tree_flatten, tree_leaves, tree_map,
                                     tree_unflatten)


def _tree_sqnorm(tree) -> torch.Tensor:
    return sum(torch.sum(torch.square(x.to(torch.float32)))
               for x in tree_leaves(tree))


def _grad(loss_fn: Callable, params, batch):
    """∇ of ``loss_fn(params, batch)[0]``, a tree like ``params``."""
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(treedef, leaves), batch)[0]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return tree_unflatten(treedef, [torch.zeros_like(p) if g is None else g
                                    for g, p in zip(grads, leaves)])


def gradient_bias(loss_fn: Callable, params_hat, params_tilde, batch):
    """‖∇L(x̂) − ∇L(x̃)‖ for a single worker's params/batch."""
    diff = tree_map(lambda a, b: a - b, _grad(loss_fn, params_hat, batch),
                    _grad(loss_fn, params_tilde, batch))
    return torch.sqrt(_tree_sqnorm(diff))


def probe_noise(rng, probe: int, leaves) -> List[torch.Tensor]:
    """Standard normal f32 noise shaped like each leaf, one draw per probe
    from the ``torch.Generator`` ``rng`` (the reference folds the probe
    index into its key)."""
    return [torch.randn(tuple(x.shape), generator=rng, dtype=torch.float32,
                        device=x.device) for x in leaves]


def estimate_lipschitz(loss_fn: Callable, params, batch, rng, *,
                       n_probes: int = 4, eps: float = 1e-3):
    """K̂_b = max over probes of ‖g(x+δ) − g(x)‖ / ‖δ‖, ‖δ‖ = eps."""
    g0 = _grad(loss_fn, params, batch)
    leaves, treedef = tree_flatten(params)
    ks = []
    for i in range(n_probes):
        noise = probe_noise(rng, i, leaves)
        nn = torch.sqrt(sum(torch.sum(torch.square(n)) for n in noise))
        noise = [eps * n / nn for n in noise]
        pert = tree_unflatten(treedef, [
            (p.to(torch.float32) + n).to(p.dtype)
            for p, n in zip(leaves, noise)])
        g1 = _grad(loss_fn, pert, batch)
        dn = torch.sqrt(_tree_sqnorm(tree_map(lambda a, b: a - b, g1, g0)))
        ks.append(dn / eps)
    return torch.max(torch.stack(ks))


def elastic_constant(params_stacked, weights, lr) -> torch.Tensor:
    """B̂ = max_i ‖x̄ − x_i‖ / η (empirical elastic-consistency constant)."""
    xbar = consensus(params_stacked, weights)

    def per_worker_sq(p, b):
        d = p.to(torch.float32) - b[None]
        return torch.sum(torch.square(d), dim=tuple(range(1, p.dim())))

    sq = sum(tree_leaves(tree_map(per_worker_sq, params_stacked, xbar)))
    return torch.sqrt(torch.max(sq)) / max(float(lr), 1e-12)


def lemma61_bound(k_hat, lr, b_hat):
    """RHS of Lemma 6.1: 4 K² η² B² (on the *squared* bias)."""
    return 4.0 * k_hat ** 2 * lr ** 2 * b_hat ** 2
