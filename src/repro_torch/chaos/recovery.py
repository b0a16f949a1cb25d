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

The M workers are stacked on one device, so a re-sync is a row copy on the
device, in place, for every worker-stacked tensor (leading dimension M);
the state's ``read`` and ``write`` may be one plane, and copying its rows
twice is harmless. The mass split runs in numpy float32 on a host copy of
the M weights, the reference's arithmetic, and goes back to the device.
Recovery is a rare event at the step boundary, never part of the step.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _row_copy_(tree, peer: int, donor: int, M: int) -> None:
    """``leaf[peer] = leaf[donor]`` in place for every worker-stacked
    tensor of a (dict / list / tuple) tree."""
    if isinstance(tree, torch.Tensor):
        if tree.dim() >= 1 and tree.shape[0] == M:
            tree[peer].copy_(tree[donor])
        # a worker-shared tensor (e.g. FIFO stamps): nothing to sync
    elif isinstance(tree, dict):
        for v in tree.values():
            _row_copy_(v, peer, donor, M)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _row_copy_(v, peer, donor, M)


def split_mass(w: np.ndarray, peer: int, donor: int, damp: float) -> None:
    """The donor's push-sum mass split with the peer, in place on a host
    float32 copy of the weights (the reference's arithmetic)."""
    share = np.asarray(w[donor] * 0.5 * damp, w.dtype)
    w[donor] = w[donor] - share  # exact: Σw is the same two terms
    w[peer] = share


def resync_peer(state: Dict[str, object], peer: int, donor: int, M: int, *,
                damp: float = 1.0) -> Dict[str, object]:
    """Re-sync ``peer``'s replica from ``donor`` and split the donor's
    push-sum mass. The state's tensors are updated in place (the caller
    has made sure no queued work still uses them); ``w`` is replaced by a
    fresh tensor. Returns the state dict (``alive`` is set by the caller
    from the health tracker's mask)."""
    if peer == donor:
        raise ValueError("recovery donor must differ from the peer")
    if not 0.0 < damp <= 1.0:
        raise ValueError(f"recovery damp must be in (0, 1], got {damp}")
    state = dict(state)
    for key in ("read", "write", "opt", "versions", "resid", "theta"):
        if key in state:
            _row_copy_(state[key], peer, donor, M)
    if "fifo" in state:
        _row_copy_(state["fifo"]["g"], peer, donor, M)
    w_dev = state["w"]
    w = w_dev.detach().cpu().numpy().copy()
    split_mass(w, peer, donor, damp)
    state["w"] = torch.from_numpy(w).to(w_dev.device)
    return state
