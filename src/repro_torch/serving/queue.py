"""Admission-controlled request queue in front of the serve loop (a copy
of ``repro/serving/queue.py``, which needs only the standard library).

When training runs at full tilt on the same host devices, serve-step
latency degrades — every decode dispatch queues behind in-flight training
stages. An unbounded request queue would turn that into unbounded latency
for everyone; the admission controller instead degrades *gracefully*:

* **bounded depth** — past ``max_depth`` waiting requests, new arrivals
  are rejected immediately with a ``retry_after_s`` hint derived from the
  measured drain rate (reject-fast beats queue-forever for open-loop
  traffic);
* **per-request deadlines** — a request that has not been admitted into a
  decode slot by its deadline is dropped at dequeue time (its tokens
  would arrive too late to matter; serving them would only push everyone
  else past *their* deadlines).

The controller is thread-safe: the request generator submits from its own
thread while the serving loop drains via :meth:`take`.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Tuple


@dataclass(frozen=True)
class Ticket:
    """Admission outcome: ``accepted``, or rejected with a retry hint."""

    accepted: bool
    retry_after_s: float = 0.0
    reason: str = ""


class AdmissionQueue:
    """Bounded FIFO with deadline drop and a measured-drain retry hint."""

    def __init__(self, max_depth: int = 64):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = int(max_depth)
        self._lock = threading.Lock()
        self._q: Deque[Tuple[object, Optional[float]]] = deque()
        # drain-rate EMA (seconds per dequeued request) for retry_after
        self._drain_ema_s = 0.05
        self._last_take: Optional[float] = None
        self.submitted = 0
        self.admitted = 0
        self.rejected = 0
        self.deadline_dropped = 0

    def submit(self, request, *, deadline_s: Optional[float] = None,
               now: Optional[float] = None) -> Ticket:
        """Try to enqueue; on overload reject with a retry-after estimate
        (depth x measured drain time). ``deadline_s`` is an absolute
        ``time.monotonic()`` bound on *admission into a slot*."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self.submitted += 1
            if len(self._q) >= self.max_depth:
                self.rejected += 1
                retry = max(0.001, len(self._q) * self._drain_ema_s)
                return Ticket(accepted=False, retry_after_s=retry,
                              reason="queue-full")
            self._q.append((request, deadline_s))
            return Ticket(accepted=True)

    def take(self, k: int, now: Optional[float] = None) -> List[object]:
        """Dequeue up to ``k`` admissible requests, dropping any whose
        deadline already passed (counted in ``deadline_dropped``)."""
        now = time.monotonic() if now is None else now
        out: List[object] = []
        with self._lock:
            while self._q and len(out) < k:
                req, deadline = self._q.popleft()
                if deadline is not None and now > deadline:
                    self.deadline_dropped += 1
                    continue
                out.append(req)
            if out:
                if self._last_take is not None:
                    dt = max(1e-4, (now - self._last_take) / len(out))
                    self._drain_ema_s += 0.2 * (dt - self._drain_ema_s)
                self._last_take = now
                self.admitted += len(out)
        return out

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def stats(self) -> dict:
        with self._lock:
            return {"submitted": self.submitted, "admitted": self.admitted,
                    "rejected": self.rejected,
                    "deadline_dropped": self.deadline_dropped,
                    "depth": len(self._q),
                    "drain_ema_s": self._drain_ema_s}
