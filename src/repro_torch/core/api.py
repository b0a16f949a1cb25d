"""Push-sum consensus and model disagreement (port of the two functions of
``repro/core/api.py`` the prod trainer reports; the sim trainer is a later
slice, ROADMAP queue 1, item 13)."""
from __future__ import annotations

import torch

from repro_torch.core.pytree import tree_leaves, tree_map


def consensus(params, weights: torch.Tensor):
    """Push-sum consensus estimate x̄ = Σ_i w_i x_i / Σ_i w_i over the
    leading worker axis of every leaf."""
    wsum = torch.clamp(torch.sum(weights), min=1e-12)

    def f(p):
        w = weights.reshape((-1,) + (1,) * (p.dim() - 1)).to(torch.float32)
        return torch.sum(w * p.to(torch.float32), dim=0) / wsum
    return tree_map(f, params)


def disagreement(params, weights: torch.Tensor) -> torch.Tensor:
    """Mean over workers of ‖x_i − x̄‖ (the paper's 'model disagreement')."""
    xbar = consensus(params, weights)

    def sq(p, b):
        d = p.to(torch.float32) - b[None]
        return torch.sum(torch.square(d), dim=tuple(range(1, p.dim())))

    per_worker = sum(tree_leaves(tree_map(sq, params, xbar)))
    return torch.mean(torch.sqrt(per_worker))
