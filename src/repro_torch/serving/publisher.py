"""PlanePublisher — the training→serving handoff of the flat read plane
(port of ``repro/serving/publisher.py``).

At every step boundary the decoupled lane holds one fully-materialized
flat parameter plane (DESIGN.md §9/§11). Once per gossip round the
training side calls :meth:`PlanePublisher.publish` with the read-plane
buffers, the per-group version clocks, the push-sum weights and
(optionally) the figA1 disagreement metric, and any number of serving
consumers pick up the latest :class:`PlaneSnapshot` without a checkpoint.

**What gets copied.** In the port both training lanes write the read
plane in place on a later step: the monolithic step consumes its state,
and the pipeline engine's fused gossip stage writes the mixed plane into
the buffer that is also the next read plane. So both publish with
``stable=False``, and each group buffer is stabilized with one device
``clone()`` on the trainer's current CUDA stream (the reference's pipeline
engine never writes its read plane and publishes zero-copy). ``versions``
and ``w`` are always cloned. ``stable=True`` keeps the handles as they are,
for a producer that never writes them again.

**Over ranks.** A trainer over a ``WorkerMesh`` with a process group
publishes on each rank that rank's ``(L, group_size)`` rows, and the
snapshot names the global rows it holds (``rows``); ``versions`` and ``w``
are over all M, as the state holds them.

**No host wait.** The clones are queued on the trainer's stream; the
snapshot carries a CUDA event recorded after them (and after the drift
metric, computed earlier on the same stream), and consumers make their
own stream wait on it before reading (``policy.snap_ready``). The
snapshot swap is a lock-protected reference assignment.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch


@dataclass(frozen=True)
class PlaneSnapshot:
    """One published read plane: buffers + provenance, immutable.

    ``plane`` maps plane-buffer name → stacked ``(M, group_size)`` tensor
    (the FlatPartition layout), or a rank's ``(L, group_size)`` rows, the
    global workers ``rows`` (``None``: all M); ``versions`` is the ``(M, G)`` per-group
    version clock and ``step`` the training step that produced the plane.
    ``drift`` is the figA1 disagreement metric when the producing backend
    measures it (``measure_drift=True``), else None. On a CUDA device
    ``event`` is recorded on ``stream`` after the snapshot's copies; a
    consumer on another stream waits on it before reading (None on the
    CPU)."""

    seq: int                      # monotone publish counter
    step: int                     # training step index at publish
    plane: Dict[str, Any]         # {group: (M, size) tensor}
    versions: Any                 # (M, G) float32 version clocks (copy)
    w: Any                        # (M,) push-sum weights (copy)
    drift: Optional[Any] = None   # figA1 disagreement, if measured
    published_at: float = 0.0     # host monotonic time of publish
    event: Optional[Any] = None   # torch.cuda.Event after the copies
    stream: Optional[Any] = None  # the CUDA stream the copies were made on
    rows: Optional[range] = None  # global rows of ``plane`` (None: all M)

    def row_of(self, worker: int) -> int:
        """Global ``worker``'s row in ``plane``; ``ValueError`` when this
        snapshot does not hold it (another rank's worker)."""
        if self.rows is None:
            return int(worker)
        if int(worker) not in self.rows:
            raise ValueError(f"worker {worker} is not in this snapshot's "
                             f"rows {self.rows.start}..{self.rows.stop - 1}")
        return int(worker) - self.rows.start


@dataclass
class PublisherStats:
    published: int = 0
    skipped: int = 0              # publish calls below the `every` cadence
    copied_planes: int = 0        # stabilizing copies (stable=False)


def _clone(x):
    return torch.as_tensor(x).clone()


class PlanePublisher:
    """Single-producer, multi-consumer atomic handoff of the read plane.

    ``every`` subsamples the publish cadence: the trainer calls
    :meth:`publish` once per gossip round and the publisher keeps every
    ``every``-th call (1 = every round). Consumers poll :meth:`latest`
    (non-blocking) or :meth:`wait_for` (blocking with timeout)."""

    def __init__(self, every: int = 1):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.every = int(every)
        self.stats = PublisherStats()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._latest: Optional[PlaneSnapshot] = None
        self._seq = 0
        self._calls = 0

    def publish(self, plane: Dict[str, Any], versions, w, step: int, *,
                drift=None, stable: bool = True,
                rows: Optional[range] = None) -> Optional[PlaneSnapshot]:
        """Publish the current read plane; returns the snapshot, or None
        when skipped by the ``every`` cadence. ``rows``: the global workers
        the plane's rows are (a rank's; ``None``: all M).

        ``stable=True`` promises the plane buffers are never written by a
        later training step; with ``stable=False`` each group buffer is
        stabilized with a device ``clone()`` on the current stream first.
        ``versions``/``w`` are always cloned. Never waits for the device."""
        self._calls += 1
        if (self._calls - 1) % self.every != 0:
            self.stats.skipped += 1
            return None
        with torch.no_grad():
            if not stable:
                plane = {g: b.clone() for g, b in plane.items()}
                self.stats.copied_planes += 1
            snap_versions = _clone(versions)
            snap_w = _clone(w)
        event = stream = None
        if snap_versions.device.type == "cuda":
            stream = torch.cuda.current_stream(snap_versions.device)
            event = torch.cuda.Event()
            event.record(stream)
        with self._cond:
            self._seq += 1
            snap = PlaneSnapshot(seq=self._seq, step=int(step), plane=plane,
                                 versions=snap_versions, w=snap_w,
                                 drift=drift,
                                 published_at=time.monotonic(),
                                 event=event, stream=stream,
                                 rows=None if rows is None else range(
                                     rows.start, rows.stop))
            self._latest = snap
            self.stats.published += 1
            self._cond.notify_all()
        return snap

    def latest(self, after_seq: int = -1) -> Optional[PlaneSnapshot]:
        """The most recent snapshot, or None if none newer than
        ``after_seq`` has been published. Non-blocking."""
        with self._lock:
            s = self._latest
        if s is None or s.seq <= after_seq:
            return None
        return s

    def wait_for(self, after_seq: int = -1,
                 timeout: Optional[float] = None) -> Optional[PlaneSnapshot]:
        """Block until a snapshot newer than ``after_seq`` arrives (or
        timeout); returns it, or None on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while (self._latest is None
                   or self._latest.seq <= after_seq):
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining)
            return self._latest
