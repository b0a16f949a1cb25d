"""AD-PSGD baseline (Lian et al., 2018); port of ``repro/core/adpsgd.py``.

Asynchronous decentralized SGD with *symmetric* pairwise averaging: each
iteration the workers form a random matching, each matched pair averages
its parameters, then applies its local update. Matched workers stamp every
layer group with ``step`` (the partner's start-of-iteration state).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import DistAlgorithm, columns_, register_algorithm
from repro_torch.core.layerview import LayerView, stamp_groups
from repro_torch.core.pytree import tree_map


def draw_permutation(rng, M: int, device) -> torch.Tensor:
    """A uniform permutation of ``range(M)`` on ``device``, from ``rng``
    (the reference's ``jax.random.permutation(rng, M)``)."""
    return torch.randperm(M, generator=rng, device=device)


def random_matching(rng, M: int, device=None) -> torch.Tensor:
    """Partner index per worker (an involution; with odd M the odd one out
    maps to itself)."""
    perm = draw_permutation(rng, M, device).to(torch.int64)
    ar = torch.arange(M, device=perm.device)
    partner_of_perm = ar + torch.where(ar % 2 == 0, 1, -1)
    partner_of_perm = torch.where(partner_of_perm >= M, ar, partner_of_perm)
    partner = torch.zeros((M,), dtype=torch.int64, device=perm.device)
    partner[perm] = perm[partner_of_perm]
    return partner


class ADPSGD(DistAlgorithm):
    name = "adpsgd"
    asynchronous = True

    def post(self, view: LayerView, weights, extras, updates, active, rng,
             step: int):
        M = weights.shape[0]
        partner = random_matching(rng, M, weights.device)
        a = active.to(torch.float32)

        # stragglers still take part in the averaging (they are passive)
        def avg_then_update(p, u):
            pf = p.to(torch.float32)
            mixed = 0.5 * (pf + pf.index_select(0, partner))
            return (mixed + self._bcast(a, p) * u.to(torch.float32)).to(
                p.dtype)

        new_groups = tree_map(lambda p, u: columns_(avg_then_update, p, u),
                              view.groups, updates)
        matched = partner != torch.arange(M, device=partner.device)
        versions = stamp_groups(view.versions, float(np.float32(step)),
                                worker_mask=matched)
        return (view.with_groups(new_groups).with_versions(versions),
                weights, extras,
                {"pairs": torch.sum(matched.to(torch.float32)) / 2})


@register_algorithm("adpsgd")
def _adpsgd():
    return ADPSGD()
