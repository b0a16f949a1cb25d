"""Peer recovery: donor re-sync of a re-admitted worker's replica (port of
``repro/chaos/recovery.py``).

A DEAD peer that comes back does NOT restart training from scratch: it
re-syncs its whole per-worker replica row (flat parameter planes, read and
write, optimizer state, version clocks, error-feedback residual plane, the
stale-θ reference and its gradient-FIFO lane) from a live *donor*, then
re-enters mixing carrying an exact share of the donor's push-sum mass
(DESIGN.md §15). The mass split is exact by construction::

    w_peer  = damp * w_donor / 2
    w_donor = w_donor - w_peer          # Σw unchanged, bitwise

``damp`` < 1 (the delay compensation strength λ when enabled)
under-weights the re-admitted peer's first mixing rounds.

With the M workers stacked on one device a re-sync is a row copy on the
device, in place, for every worker-stacked tensor (leading dimension M) of
the state's per-worker entries (``launch.mesh.WORKER_ENTRIES``). Over a
:class:`~repro_torch.launch.mesh.WorkerMesh` with a process group the row
entries hold each rank's L rows: a donor on another rank sends its rows
point to point (:meth:`~repro_torch.launch.mesh.WorkerMesh.copy_row_`),
and the version clocks, which every rank keeps whole, are copied on every
rank. The state's ``read`` and ``write`` may be one plane: its rows are
copied once. The mass split runs in numpy float32 on a host copy of the M
weights (the reference's arithmetic, on every rank alike) and goes back to
the device. Recovery is a rare event at the step boundary, never part of
the step.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.launch.mesh import ROW_ENTRIES, WORKER_ENTRIES


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _entry(state, path):
    for k in path:
        if not isinstance(state, dict) or k not in state:
            return None
        state = state[k]
    return state


def split_mass(w: np.ndarray, peer: int, donor: int, damp: float) -> None:
    """The donor's push-sum mass split with the peer, in place on a host
    float32 copy of the weights (the reference's arithmetic)."""
    share = np.asarray(w[donor] * 0.5 * damp, w.dtype)
    w[donor] = w[donor] - share  # exact: Σw is the same two terms
    w[peer] = share


def resync_peer(state: Dict[str, object], peer: int, donor: int, M: int, *,
                damp: float = 1.0, mesh=None) -> Dict[str, object]:
    """Re-sync ``peer``'s replica from ``donor`` and split the donor's
    push-sum mass. The state's tensors are updated in place (the caller
    has made sure no queued work still uses them); ``w`` is replaced by a
    fresh tensor. Returns the state dict (``alive`` is set by the caller
    from the health tracker's mask).

    ``mesh`` (a ``WorkerMesh`` with a process group): the state is a
    rank's, its row entries holding the rank's rows; every rank calls this
    with the same arguments, and the rows cross ranks where the donor's
    owner is not the peer's."""
    if peer == donor:
        raise ValueError("recovery donor must differ from the peer")
    if not 0.0 < damp <= 1.0:
        raise ValueError(f"recovery damp must be in (0, 1], got {damp}")
    ring = mesh if mesh is not None and mesh.group is not None else None
    state = dict(state)
    copied = set()
    for path in WORKER_ENTRIES:
        spread = ring is not None and path in ROW_ENTRIES
        rows = ring.local_workers if spread else M
        for leaf in _leaves(_entry(state, path)):
            # a worker-shared tensor (e.g. adamw's count) has no rows
            if leaf.dim() < 1 or leaf.shape[0] != rows or id(leaf) in copied:
                continue
            copied.add(id(leaf))
            if spread:
                ring.copy_row_(leaf, donor, peer)
            else:
                leaf[peer].copy_(leaf[donor])
    w_dev = state["w"]
    w = w_dev.detach().cpu().numpy().copy()
    split_mass(w, peer, donor, damp)
    state["w"] = torch.from_numpy(w).to(w_dev.device)
    return state
