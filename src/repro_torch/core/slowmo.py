"""SlowMo baseline (Wang et al.): Local SGD + slow outer momentum; port of
``repro/core/slowmo.py``.

Every ``sync_every`` steps: x̄ ← mean(x); u ← β·u + (z − x̄)/η_out;
z ← z − η_out·u; all replicas reset to z. Needs an extra model-sized buffer
(z and u, single-worker). Clocks follow Local SGD. ``step`` is a host
integer, so the outer step runs only on the steps that sync (the reference
computes it every step and selects with ``jnp.where``): the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import DistAlgorithm, add_, register_algorithm
from repro_torch.core.layerview import LayerView, stamp_groups
from repro_torch.core.pytree import tree_map


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


class SlowMo(DistAlgorithm):
    asynchronous = False

    def __init__(self, sync_every: int = 8, outer_lr: float = 1.0,
                 outer_beta: float = 0.5, name: str = "slowmo"):
        self.H = sync_every
        self.outer_lr = outer_lr
        self.outer_beta = outer_beta
        self.name = name

    def init_extras(self, view: LayerView, M: int):
        single = tree_map(lambda p: p[0].clone(), view.groups)
        return {"z": single, "u": tree_map(torch.zeros_like, single)}

    def _outer(self, avg, extras):
        """One outer step from the average ``avg`` (f32, single-worker):
        the new (z, u) in the dtypes of ``extras``'."""
        u = tree_map(lambda uu, z, xa: self.outer_beta * _f32(uu)
                     + (_f32(z) - _f32(xa)) / self.outer_lr,
                     extras["u"], extras["z"], avg)
        z = tree_map(lambda zz, uu: _f32(zz) - self.outer_lr * uu,
                     extras["z"], u)
        return (tree_map(lambda a, b: a.to(b.dtype), z, extras["z"]),
                tree_map(lambda a, b: a.to(b.dtype), u, extras["u"]))

    @staticmethod
    def _mean(groups):
        return tree_map(lambda p: torch.mean(_f32(p), dim=0), groups)

    @staticmethod
    def _reset_to(groups, z):
        """Every replica set to ``z`` (in the params' dtype), in place."""
        return tree_map(lambda p, zz: p.copy_(zz[None].expand(p.shape)),
                        groups, z)

    def post(self, view: LayerView, weights, extras, updates, active, rng,
             step: int):
        new_groups = tree_map(add_, view.groups, updates)
        sync = (int(step) + 1) % self.H == 0
        versions = view.versions
        if sync:
            z, u = self._outer(self._mean(new_groups), extras)
            extras = {"z": z, "u": u}
            new_groups = self._reset_to(new_groups, z)
            versions = stamp_groups(versions,
                                    float(np.float32(step) + np.float32(1.0)))
        return (view.with_groups(new_groups).with_versions(versions), weights,
                extras, {"synced": float(sync)})


@register_algorithm("slowmo")
def _slowmo(sync_every: int = 8, outer_lr: float = 1.0,
            outer_beta: float = 0.5):
    return SlowMo(sync_every, outer_lr, outer_beta)
