"""Local SGD baseline (Stich, 2019): H local steps, then full averaging;
port of ``repro/core/localsgd.py``. Every group is stamped to ``step + 1``
on sync steps only. ``step`` is a host integer, so the average is computed
only on the steps that sync (the reference selects with ``jnp.where``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import (DistAlgorithm, add_, columns_,
                                  register_algorithm)
from repro_torch.core.layerview import LayerView, stamp_groups
from repro_torch.core.pytree import tree_map


def _mean_rows(p: torch.Tensor) -> torch.Tensor:
    avg = torch.mean(p.to(torch.float32), dim=0, keepdim=True)
    return avg.expand(p.shape).to(p.dtype)


def replicate_mean(p: torch.Tensor) -> torch.Tensor:
    """Every worker's row replaced, in place, by the f32 mean over workers
    in the buffer's dtype."""
    return columns_(_mean_rows, p)


class LocalSGD(DistAlgorithm):
    asynchronous = False

    def __init__(self, sync_every: int = 8, name: str = "localsgd"):
        self.H = sync_every
        self.name = name

    def post(self, view: LayerView, weights, extras, updates, active, rng,
             step: int):
        new_groups = tree_map(add_, view.groups, updates)
        sync = (int(step) + 1) % self.H == 0
        versions = view.versions
        if sync:
            new_groups = tree_map(replicate_mean, new_groups)
            versions = stamp_groups(versions,
                                    float(np.float32(step) + np.float32(1.0)))
        return (view.with_groups(new_groups).with_versions(versions),
                weights, extras, {"synced": float(sync)})


@register_algorithm("localsgd")
def _localsgd(sync_every: int = 8):
    return LocalSGD(sync_every)
