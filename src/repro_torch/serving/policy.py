"""SwapPolicy — staleness/drift-gated acceptance of published planes (a
copy of ``repro/serving/policy.py``: host values come through ``.cpu()``,
after the snapshot's CUDA event, and ``layer_staleness`` from
``repro_torch.core.layerview``).

Delay-aware ASGD variants (DaSGD's delayed averaging, Zheng et al.'s delay
compensation — PAPERS.md) all trade parameter freshness against stability.
The serving side faces the same trade at swap time: a freshly gossiped
plane is *usually* the best thing to serve, but mid-divergence (high
disagreement) or deep-staleness planes can be worse than the params
already serving. The policy makes that trade explicit, using exactly the
accounting the training side already produces:

* **per-group staleness** — the ``(M, G)`` version clocks stamped by the
  gossip stage (``t + phi_g``, DESIGN.md §4) against the publishing step:
  ``layer_staleness(versions, step)``, the same metric the figA1/table
  benchmarks report. Gate: the max over groups must stay under
  ``max_staleness`` (in iterations).
* **drift** — the figA1 disagreement metric ``mean_i ||x_i - x_bar||``
  carried on the snapshot when the backend measures it. Gate: must stay
  under ``max_drift``.
* **swap cadence** — ``min_interval_steps`` rejects planes that arrive
  too soon after the last accepted swap (swapping costs an unpack and a
  jit-cache-warm decode step; don't thrash), while ``max_interval_steps``
  *force-accepts* once the serving params fall that many steps behind:
  past the bound, freshness beats the drift/staleness gates (the serve
  params' own staleness is then the larger divergence risk). A forced
  accept is recorded with its own reason so the trade stays visible.

``evaluate`` converts the snapshot's (possibly in-flight) version/drift
tensors to host values — it blocks the CALLING thread, which is the
serving side's poll loop, never the trainer.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch


def to_host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def snap_ready(snap) -> None:
    """Make the current CUDA stream wait for the snapshot's copies (its
    ``event``, recorded on the publishing stream after them); nothing to
    wait for on the CPU or for a snapshot without one."""
    event = getattr(snap, "event", None)
    if event is not None:
        torch.cuda.current_stream(snap.stream.device).wait_event(event)


@dataclass(frozen=True)
class SwapDecision:
    """Outcome of gating one snapshot. ``reason`` is one of
    ``fresh`` / ``forced-max-interval`` (accepted) or
    ``min-interval`` / ``staleness`` / ``drift`` /
    ``unhealthy-source`` (rejected)."""

    accepted: bool
    reason: str
    seq: int
    step: int
    staleness_max: float = 0.0
    drift: Optional[float] = None


@dataclass
class SwapPolicy:
    """Accept/reject a published plane for serving. All gates default to
    disabled (None / 0), i.e. accept-everything; configure what the
    deployment cares about."""

    max_staleness: Optional[float] = None   # max per-group staleness, iters
    max_drift: Optional[float] = None       # figA1 disagreement bound
    min_interval_steps: int = 0             # min training steps between swaps
    max_interval_steps: Optional[int] = None  # force-accept beyond this
    # membership view (a repro_torch.chaos.PeerHealth): refuse snapshots whose
    # source worker is suspect/dead — a crashed peer's frozen replica
    # must never reach serving, DESIGN.md §15
    health: Optional[object] = None
    counts: Dict[str, int] = field(default_factory=dict)

    def _decide(self, snap, last_swap_step: Optional[int],
                worker: Optional[int]) -> SwapDecision:
        from repro_torch.core.layerview import layer_staleness

        # host conversions: blocks this (serving) thread until the
        # producing step's gossip has materialized the clocks
        snap_ready(snap)
        versions = torch.as_tensor(to_host(snap.versions), dtype=torch.float32)
        stale = layer_staleness(versions, snap.step).numpy()
        stale_max = float(stale.max()) if stale.size else 0.0
        drift = None if snap.drift is None else float(to_host(snap.drift))
        age = (None if last_swap_step is None
               else snap.step - int(last_swap_step))

        def dec(accepted, reason):
            return SwapDecision(accepted=accepted, reason=reason,
                                seq=snap.seq, step=snap.step,
                                staleness_max=stale_max, drift=drift)

        # the health gate comes FIRST — it beats even the forced accept:
        # freshness never outranks serving a suspect/dead worker's replica
        if (self.health is not None and worker is not None
                and not self.health.serving_ok(worker)):
            return dec(False, "unhealthy-source")
        if age is not None and age < self.min_interval_steps:
            return dec(False, "min-interval")
        if (self.max_interval_steps is not None and age is not None
                and age >= self.max_interval_steps):
            return dec(True, "forced-max-interval")
        if self.max_staleness is not None and stale_max > self.max_staleness:
            return dec(False, "staleness")
        if (self.max_drift is not None and drift is not None
                and drift > self.max_drift):
            return dec(False, "drift")
        return dec(True, "fresh")

    def evaluate(self, snap, last_swap_step: Optional[int] = None,
                 worker: Optional[int] = None) -> SwapDecision:
        """Gate one snapshot against the last accepted swap's step.
        ``worker`` is the publishing worker's index for the health gate
        (ignored when no ``health`` view is configured)."""
        d = self._decide(snap, last_swap_step, worker)
        self.counts[d.reason] = self.counts.get(d.reason, 0) + 1
        return d

    @property
    def rejected(self) -> int:
        return sum(n for r, n in self.counts.items()
                   if r in ("min-interval", "staleness", "drift",
                            "unhealthy-source"))

    @property
    def gated_rejections(self) -> int:
        """Rejections from the divergence gates specifically (staleness or
        drift) — the bench's acceptance hook."""
        return (self.counts.get("staleness", 0)
                + self.counts.get("drift", 0))

    @property
    def accepted(self) -> int:
        return (self.counts.get("fresh", 0)
                + self.counts.get("forced-max-interval", 0))
