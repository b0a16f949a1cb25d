"""CO2 baseline (Sun et al., 2024): Local SGD whose outer averaging and
momentum step overlaps communication by operating on a *stale*
(one-outer-round-old) average; port of ``repro/core/co2.py`` (without the
penalty-gap correction, as the paper's own comparison).

Sync steps stamp ``step + 1 − H``: the outer step consumes the previous
round's average. ``step`` is a host integer, so the outer step runs only on
the steps that sync.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.api import register_algorithm
from repro_torch.core.layerview import LayerView, stamp_groups
from repro_torch.core.pytree import tree_map
from repro_torch.core.slowmo import SlowMo


class CO2(SlowMo):
    asynchronous = True  # the overlapped outer step tolerates stragglers

    def __init__(self, sync_every: int = 8, outer_lr: float = 1.0,
                 outer_beta: float = 0.5):
        super().__init__(sync_every, outer_lr, outer_beta, name="co2")

    def init_extras(self, view: LayerView, M: int):
        base = super().init_extras(view, M)
        base["stale_avg"] = tree_map(lambda z: z.clone(), base["z"])
        return base

    def post(self, view: LayerView, weights, extras, updates, active, rng,
             step: int):
        new_groups = self.masked_apply(view.groups, updates, active)
        sync = (int(step) + 1) % self.H == 0
        versions = view.versions
        if sync:
            # the outer step uses the STALE average (communication
            # overlapped); this round's mean replaces it ("arrives later")
            z, u = self._outer(extras["stale_avg"], extras)
            stale = tree_map(lambda a, b: a.to(b.dtype),
                             self._mean(new_groups), extras["stale_avg"])
            extras = {"z": z, "u": u, "stale_avg": stale}
            new_groups = self._reset_to(new_groups, z)
            versions = stamp_groups(
                versions, float(np.float32(step) + np.float32(1.0)
                                - np.float32(self.H)))
        return (view.with_groups(new_groups).with_versions(versions), weights,
                extras, {"synced": float(sync)})


@register_algorithm("co2")
def _co2(sync_every: int = 8, outer_lr: float = 1.0, outer_beta: float = 0.5):
    return CO2(sync_every, outer_lr, outer_beta)
