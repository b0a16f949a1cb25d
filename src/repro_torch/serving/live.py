"""LiveServer — continuous deployment of a continuously-training model
(port of ``repro/serving/live.py``).

Composes the subsystem: a :class:`~repro_torch.serving.publisher.
PlanePublisher` feeds read-plane snapshots from the trainer, a
:class:`~repro_torch.serving.policy.SwapPolicy` gates them, and accepted
planes are unpacked through the training ``FlatPartition`` straight into
the :class:`~repro_torch.launch.serve.ServeLoop`'s params — no checkpoint
save/load anywhere on the path. An optional
:class:`~repro_torch.serving.queue.AdmissionQueue` fronts the loop's own
slot queue with overload control.

**Swap atomicity.** The unpack makes one contiguous copy of worker ``w``'s
row of every ``(M, size)`` group buffer and unpacks it with
``FlatPartition.unpack`` (views of that copy), so the produced parameter
tree is derived from exactly one plane version and pins no whole
snapshot. The swap itself is a single reference assignment performed
between decode steps (``poll`` runs at step boundaries): a decode step
either sees the whole old tree or the whole new one.

**Over ranks.** Behind a trainer over a ``WorkerMesh`` with a process
group, ``LiveServer(worker=j, mesh=mesh)`` serves global worker ``j`` on
the rank that owns it, from its local row of the rank's published plane;
on another rank the constructor raises ``ValueError``. No row crosses
ranks for serving.

**Streams.** Before it reads a snapshot the server's current CUDA stream
waits on the snapshot's event (the trainer's copies). The copies were made
on the trainer's stream; when the server reads them from another stream it
marks them with ``record_stream``, so that the caching allocator does not
hand their memory out again (when the publisher drops the snapshot for a
newer one) before the server's copy of the row has run.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from repro_torch.serving.policy import (SwapDecision, SwapPolicy,
                                        snap_ready, to_host)
from repro_torch.serving.publisher import PlanePublisher
from repro_torch.serving.queue import AdmissionQueue


@dataclass(frozen=True)
class SwapRecord:
    """Provenance of one accepted swap: which snapshot, when, and the
    host-side copy of its version clocks (all groups from one publish —
    the atomicity invariant tests assert on)."""

    seq: int
    step: int
    reason: str
    at_serve_step: int
    versions: Any  # (M, G) numpy copy at swap time


class LiveServer:
    """Drive a :class:`ServeLoop` on live, staleness-gated weights.

    ``worker`` selects which of the trainer's M per-worker replicas
    serves (the replicas converge through gossip; worker 0 by default).
    ``mesh`` (the trainer's ``WorkerMesh``): with a process group the
    worker must be one of this rank's.
    ``poll`` checks the publisher once and swaps if the policy accepts;
    ``step`` = admit → one decode step → poll, the serving inner loop.
    """

    def __init__(self, loop, part, publisher: PlanePublisher,
                 policy: Optional[SwapPolicy] = None,
                 admission: Optional[AdmissionQueue] = None,
                 worker: int = 0, mesh=None):
        if mesh is not None and mesh.group is not None:
            mesh.local_index(worker)  # raises on another rank's worker
        self.loop = loop
        self.part = part
        self.publisher = publisher
        self.policy = policy if policy is not None else SwapPolicy()
        self.admission = admission
        self.worker = int(worker)
        self.swaps: List[SwapRecord] = []
        self.decisions: List[SwapDecision] = []
        self._last_seq = -1
        self._last_swap_step: Optional[int] = None

    def _unpack(self, plane, snap=None):
        """Worker ``w``'s params from a plane: one contiguous copy of its
        row per group, unpacked into views of that copy. ``snap`` (the
        plane's snapshot) orders the copy after its event and marks its
        buffers in use on this stream."""
        if snap is not None:
            snap_ready(snap)
        w = self.worker if snap is None else snap.row_of(self.worker)
        row = {}
        with torch.no_grad():
            for g, b in plane.items():
                if (snap is not None and snap.stream is not None
                        and torch.cuda.current_stream(b.device)
                        != snap.stream):
                    b.record_stream(torch.cuda.current_stream(b.device))
                row[g] = b[w].clone()
        return self.part.unpack(row)

    # -- swap path -----------------------------------------------------------
    def poll(self) -> Optional[SwapDecision]:
        """Evaluate the newest unseen snapshot; swap if accepted. Returns
        the decision, or None when nothing new was published. Called
        between decode steps only — the loop's params rebind atomically."""
        snap = self.publisher.latest(after_seq=self._last_seq)
        if snap is None:
            return None
        self._last_seq = snap.seq
        decision = self.policy.evaluate(snap,
                                        last_swap_step=self._last_swap_step,
                                        worker=self.worker)
        self.decisions.append(decision)
        if decision.accepted:
            params = self._unpack(snap.plane, snap)
            self.loop.set_params(params, version=(snap.seq, snap.step))
            self._last_swap_step = snap.step
            self.swaps.append(SwapRecord(
                seq=snap.seq, step=snap.step, reason=decision.reason,
                at_serve_step=self.loop.steps_run,
                versions=to_host(snap.versions)))
        return decision

    # -- serve loop ----------------------------------------------------------
    def _admit_from_queue(self) -> None:
        if self.admission is None:
            return
        free = sum(1 for s in self.loop.slots if s.req is None)
        room = free + max(0, 2 * self.loop.num_slots - len(self.loop.queue))
        for req in self.admission.take(room):
            self.loop.submit(req)

    def step(self) -> bool:
        """One serving iteration: drain admissions, run one decode step,
        then consider a swap at the step boundary. Returns False when
        there was nothing to decode (idle)."""
        self._admit_from_queue()
        progressed = self.loop.step_once()
        self.poll()
        return progressed

    def run_for(self, duration_s: float, *,
                idle_sleep_s: float = 0.002) -> None:
        """Serve for a wall-clock window (the benchmark's inner loop)."""
        t_end = time.monotonic() + duration_s
        while time.monotonic() < t_end:
            if not self.step():
                time.sleep(idle_sleep_s)

    def run_until_idle(self, max_steps: int = 10_000) -> None:
        """Serve until both queues drain (the example's inner loop)."""
        for _ in range(max_steps):
            if not self.step() and (self.admission is None
                                    or self.admission.depth == 0):
                break

    # -- accounting ----------------------------------------------------------
    @property
    def swap_count(self) -> int:
        return len(self.swaps)

    def stats(self) -> Dict[str, Any]:
        out = dict(self.loop.stats())
        out.update(swaps=self.swap_count,
                   publishes_seen=len(self.decisions),
                   swap_rejected=self.policy.rejected,
                   swap_rejected_gated=self.policy.gated_rejections,
                   swap_reasons=dict(self.policy.counts),
                   last_swap_step=self._last_swap_step)
        if self.admission is not None:
            out["admission"] = self.admission.stats()
        return out
