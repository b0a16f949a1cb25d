"""The worker mesh of one device (port of ``repro/launch/mesh.py``).

The JAX package spreads its gossip workers over the ``("pod", "data")`` axes
of a device mesh and shards each worker's parameters over ``"model"``. The
port stacks the M workers on the leading dimension of every buffer on one
device, as its lanes already do, so its mesh is just that count and the
device: :class:`WorkerMesh`, which ``make_step(model, mesh, shape, ...)``
takes where the reference takes its mesh.

``make_production_mesh`` (the TPU pod's (16, 16) and expert-parallel
layouts) has no analogue. The multi-GPU ring over ``torch.distributed`` is
ROADMAP item 15b, which gives ``WorkerMesh`` its process group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class WorkerMesh:
    """``workers`` gossip workers stacked on ``device`` (``None``: CUDA,
    which must exist)."""

    workers: int
    device: Any = None

    def __post_init__(self):
        if int(self.workers) < 1:
            raise ValueError(f"a mesh needs >= 1 worker, got {self.workers}")
