"""Peer membership tracking: liveness epochs, suspicion, death, re-entry (a
copy of ``repro/chaos/health.py``; ``wait_guarded`` waits on the port's
:class:`~repro_torch.launch.streams.SignalBoard`).

:class:`PeerHealth` is the single membership view every component of the
fault-tolerant lane consults (DESIGN.md §15): the chaos controller feeds
it liveness *epochs* (one beat per peer per step, mirrored onto the
stream engine's SignalBoard as ``live:{peer}`` slots when one is
attached), and the gossip mixes read its ``alive_mask`` to renormalize
push-sum weights over the live set.

State machine (per peer)::

    ALIVE --(suspect_after missed epochs)--> SUSPECT
    SUSPECT --(dead_after missed epochs)---> DEAD
    DEAD --(readmit, after donor re-sync)--> ALIVE

A SUSPECT peer still participates in mixing (its last payloads may be in
flight and are still valid push-sum mass) but is no longer a trusted
serving source; only DEAD removes it from the mixing set. Deadline-guarded
waits (:meth:`wait_guarded`) escalate through the same ladder instead of
letting a ``TimeoutError`` crash the run: retry with exponential backoff,
then mark the peer suspect, then dead.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"


class PeerHealth:
    """Membership state machine over ``M`` peers, driven by liveness
    epochs (monotone per-peer step counters)."""

    def __init__(self, M: int, *, suspect_after: int = 1,
                 dead_after: int = 2):
        if not 0 < suspect_after < dead_after:
            raise ValueError("need 0 < suspect_after < dead_after")
        self.M = int(M)
        self.suspect_after = int(suspect_after)
        self.dead_after = int(dead_after)
        self._status = [ALIVE] * self.M
        self._last_seen = [-1] * self.M
        # detect latency captured AT the DEAD transition — _last_seen is
        # rewritten on readmission, so it can't be recomputed later
        self._dead_latency: dict = {}
        #: transition timeline: (epoch, peer, old_status, new_status)
        self.events: List[Tuple[int, int, str, str]] = []

    # -- liveness feed ----------------------------------------------------
    def beat(self, peer: int, epoch: int) -> None:
        """Record a liveness epoch for ``peer`` (idempotent per step)."""
        if self._status[peer] == DEAD:
            return  # a dead peer must be readmitted, not just beat
        self._last_seen[peer] = max(self._last_seen[peer], int(epoch))

    def observe(self, epoch: int) -> List[Tuple[int, str]]:
        """Advance the state machine to ``epoch``; returns the peers that
        transitioned this call as ``(peer, new_status)``."""
        out: List[Tuple[int, str]] = []
        for p in range(self.M):
            if self._status[p] == DEAD:
                continue
            missed = int(epoch) - self._last_seen[p]
            if missed >= self.dead_after:
                self._transition(p, DEAD, epoch)
                out.append((p, DEAD))
            elif missed >= self.suspect_after:
                if self._status[p] == ALIVE:
                    self._transition(p, SUSPECT, epoch)
                    out.append((p, SUSPECT))
            elif self._status[p] == SUSPECT:
                self._transition(p, ALIVE, epoch)
                out.append((p, ALIVE))
        return out

    # -- explicit transitions ---------------------------------------------
    def mark_suspect(self, peer: int, epoch: int = -1) -> None:
        if self._status[peer] == ALIVE:
            self._transition(peer, SUSPECT, epoch)

    def mark_dead(self, peer: int, epoch: int = -1) -> None:
        if self._status[peer] != DEAD:
            self._transition(peer, DEAD, epoch)

    def readmit(self, peer: int, epoch: int) -> None:
        """Re-admit a peer after its donor re-sync (DESIGN.md §15)."""
        self._transition(peer, ALIVE, epoch)
        self._last_seen[peer] = int(epoch)

    def _transition(self, peer: int, new: str, epoch: int) -> None:
        old = self._status[peer]
        if old != new:
            self._status[peer] = new
            self.events.append((int(epoch), int(peer), old, new))
            if new == DEAD and epoch >= 0:
                self._dead_latency[peer] = int(epoch) - self._last_seen[peer]

    # -- views ------------------------------------------------------------
    def status(self, peer: int) -> str:
        return self._status[peer]

    def is_live(self, peer: int) -> bool:
        """Participates in mixing (ALIVE or SUSPECT)."""
        return self._status[peer] != DEAD

    def serving_ok(self, peer: int) -> bool:
        """Trusted as a serving snapshot source (strictly ALIVE)."""
        return self._status[peer] == ALIVE

    def alive_mask(self):
        """f32 0/1 mask over peers, 1 for every non-DEAD peer: the state's
        ``alive`` membership mask."""
        import numpy as np
        return np.asarray([0.0 if s == DEAD else 1.0
                           for s in self._status], np.float32)

    @property
    def peers_dead(self) -> int:
        return sum(1 for s in self._status if s == DEAD)

    @property
    def peers_suspect(self) -> int:
        return sum(1 for s in self._status if s == SUSPECT)

    def detect_latency(self, peer: int) -> Optional[int]:
        """Epochs between the peer's last beat and its DEAD transition
        (captured at the transition — stable across readmission)."""
        return self._dead_latency.get(peer)

    # -- deadline-guarded waits -------------------------------------------
    def wait_guarded(self, board, slot: str, value, peer: int, *,
                     epoch: int = 0, deadline: float = 0.05,
                     retries: int = 3, backoff: float = 2.0):
        """``board.wait_until`` with escalation instead of an escaping
        ``TimeoutError``: retry with exponential backoff, then mark the
        peer SUSPECT and grant one final grace wait, then mark it DEAD
        and return ``None`` (the caller degrades — mixes fall back to
        the live set). A success while SUSPECT re-admits via the normal
        :meth:`observe` path on the next epoch."""
        t = float(deadline)
        for _ in range(max(1, int(retries))):
            try:
                return board.wait_until(slot, value, timeout=t)
            except TimeoutError:
                t *= float(backoff)
                time.sleep(0.0)  # yield
        self.mark_suspect(peer, epoch)
        try:
            return board.wait_until(slot, value, timeout=t)
        except TimeoutError:
            self.mark_dead(peer, epoch)
            return None
