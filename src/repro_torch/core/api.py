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


# elements of a worker row that the disagreement reduces at a time: its f32
# temporaries stay at M × 64 MB instead of whole-plane copies
_DRIFT_CHUNK = 1 << 24


def disagreement(params, weights: torch.Tensor) -> torch.Tensor:
    """Mean over workers of ‖x_i − x̄‖ (the paper's 'model disagreement'),
    x̄ the push-sum consensus. Each leaf is reduced a chunk of its row at a
    time, so no plane-sized f32 copy is made; the sums' order differs from
    the JAX package's by rounding only."""
    wsum = torch.clamp(torch.sum(weights), min=1e-12)
    w = weights.to(torch.float32)[:, None]
    per_worker = 0.0
    for p in tree_leaves(params):
        rows = p.reshape(p.shape[0], -1)
        for lo in range(0, rows.shape[1], _DRIFT_CHUNK):
            pc = rows[:, lo:lo + _DRIFT_CHUNK].to(torch.float32)
            xbar = torch.sum(w * pc, dim=0) / wsum
            per_worker = per_worker + torch.sum(
                torch.square(pc - xbar[None]), dim=1)
    return torch.mean(torch.sqrt(per_worker))
