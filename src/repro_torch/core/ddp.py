"""Synchronous distributed data parallel, the paper's primary baseline;
port of ``repro/core/ddp.py``.

Gradients are averaged across workers before the optimizer step, so the
replicas stay identical. Synchronous: it ignores the straggler mask (its
straggler cost is wall-clock, ``repro_torch.core.simulator``). Every group's
clock is stamped to ``step + 1`` on every iteration: zero staleness.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import DistAlgorithm, add_, register_algorithm
from repro_torch.core.layerview import LayerView, stamp_groups
from repro_torch.core.pytree import tree_map


class DDP(DistAlgorithm):
    name = "ddp"
    asynchronous = False

    def transform_grads(self, grads, extras):
        return tree_map(lambda x: torch.mean(x, dim=0, keepdim=True)
                        .expand(x.shape), grads), extras

    def post(self, view: LayerView, weights, extras, updates, active, rng,
             step: int):
        new_groups = tree_map(add_, view.groups, updates)
        versions = stamp_groups(view.versions,
                                float(np.float32(step) + np.float32(1.0)))
        return (view.with_groups(new_groups).with_versions(versions),
                weights, extras, {})


@register_algorithm("ddp")
def _ddp():
    return DDP()
