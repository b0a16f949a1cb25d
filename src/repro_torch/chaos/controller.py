"""ChaosController: replay a :class:`FaultPlan` against a live backend (port
of ``repro/chaos/controller.py``).

The controller runs at the host step boundary (``before_step``): it feeds
per-peer liveness epochs into :class:`~repro_torch.chaos.health.PeerHealth`
(mirrored onto the stream engine's SignalBoard as ``live:{peer}`` slots),
advances the membership state machine, and applies the step's scheduled
faults to the training state:

* ``crash``: the peer stops beating; once the health tracker escalates it
  to DEAD, its ``alive`` mask entry drops to 0 and its push-sum mass is
  redistributed proportionally over the survivors (one host
  renormalization; every later round conserves Σw over the live set
  through the alive-gated exchange).
* ``hang``: the host loop sleeps (wall-clock degradation only).
* ``nan``: poisons the peer's queued delayed gradient for one layer group
  (D > 0) or its batch slice (D == 0); the update lane's nonfinite guard
  detects, skips and counts it.
* ``corrupt`` / ``drop``: one guarded wire round through
  :class:`~repro_torch.chaos.guard.WireGuard` (reject and resend; the
  repair is bit-exact by construction).
* ``recover``: donor re-sync via :func:`~repro_torch.chaos.recovery.
  resync_peer`, then re-admission with its first rounds damped through the
  push-sum mass split.

The state's ``alive`` is the host mask (numpy float32, the health
tracker's ``alive_mask()``): the step reads it to choose the alive-gated
route, and uploads it only when a peer is dead. With an *empty* plan the
controller only beats and observes; it never touches the state, so the
membership lane stays bit-exact with the fault-free lane.

Before a fault mutates the state, the engine's outstanding work is
materialized (the stream engine's ``materialize``: every task launched,
the caller's stream after all of the engine's streams), so the mutation,
enqueued on the caller's stream, follows every use of the old values; the
next step's tasks wait for the caller's stream in turn. ``event_s`` keeps
the host seconds of each fault event (``kill``, ``resync``,
``guard_round``, ``nan``).

Over a :class:`~repro_torch.launch.mesh.WorkerMesh` with a process group
(``mesh=``) the controller stays host-side and replicated: every rank
replays the same plan and keeps the same :class:`PeerHealth` of all M
peers, and the kill's renormalization runs on every rank's copy of the
``(M,)`` weights alike. A NaN lands on the owner of its peer, at its local
row. A wire fault's damage lands on the global element the one-process
round damages (byte 0 of the group's row 0), so only that row's owner
detects and repairs it; ``summary()`` sums the ranks' reject, drop and
resend counts. A donor on another rank sends its rows point to point
(:func:`~repro_torch.chaos.recovery.resync_peer`).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.chaos.guard import WireGuard
from repro_torch.chaos.health import DEAD, PeerHealth
from repro_torch.chaos.plan import Fault, FaultPlan, as_plan
from repro_torch.chaos.recovery import resync_peer


def _renorm(w: np.ndarray, peer: int, mask: np.ndarray) -> None:
    """The dead peer's mass redistributed over the survivors, in place on a
    host float32 copy of the weights (the reference's float64 arithmetic)."""
    total = w.sum(dtype=np.float64)
    w[peer] = 0.0
    live = mask > 0
    s_live = w[live].sum(dtype=np.float64)
    if s_live > 0:
        w[live] = (w[live].astype(np.float64)
                   * (total / s_live)).astype(w.dtype)


def _poison_rows(leaf, peer: int):
    """A copy of a floating batch leaf with worker ``peer``'s row set to NaN;
    other leaves (integer tokens) pass through untouched."""
    if isinstance(leaf, torch.Tensor):
        if not leaf.dtype.is_floating_point:
            return leaf
        out = leaf.clone()
        out[peer] = float("nan")
        return out
    arr = np.asarray(leaf)
    if not np.issubdtype(arr.dtype, np.floating):
        return leaf
    out = np.array(arr)
    out[peer] = np.nan
    return out


class ChaosController:
    def __init__(self, faults, M: int, *, update_delay: int = 0,
                 compensate: float = 0.0, mesh=None):
        self.plan: FaultPlan = as_plan(faults)
        self.M = int(M)
        # a mesh with a process group spreads the state's rows over ranks
        self.mesh = mesh if mesh is not None and mesh.group is not None \
            else None
        self.D = int(update_delay)
        # λ doubles as the recovery damping: the re-admitted peer's first
        # mixing rounds are under-weighted exactly like a stale gradient
        self.damp = float(compensate) if float(compensate) > 0 else 1.0
        self.health = PeerHealth(M)
        self.guard = WireGuard()
        self._crashed = set()
        self._engine = None
        self._board = None
        self.faults_injected = 0
        self.rounds_degraded = 0
        self.resyncs = 0
        self.hangs = 0
        self.nan_injections = 0
        self._death_step: Dict[int, int] = {}
        self._resync_step: Dict[int, int] = {}
        self.event_s: Dict[str, List[float]] = {}

    # -- wiring ------------------------------------------------------------
    def attach(self, *, engine=None, board=None) -> None:
        """Hook up the stream/pipeline engine (for materializing futures
        before a host mutation) and its SignalBoard (liveness mirror)."""
        self._engine = engine
        self._board = board if board is not None else getattr(
            engine, "board", None)

    # -- the per-step hook ---------------------------------------------------
    def before_step(self, state, batch, step: int):
        """Apply this step's faults; returns the (possibly re-materialized
        and mutated) ``(state, batch)``."""
        step = int(step)
        events = self.plan.at(step)
        for f in events:
            self.faults_injected += 1
            if f.kind == "crash":
                self._crashed.add(f.peer)

        # liveness epochs: every non-crashed peer beats; the mirror slot on
        # the SignalBoard is what deadline-guarded waits key off
        for p in range(self.M):
            if p not in self._crashed:
                self.health.beat(p, step)
                if self._board is not None:
                    try:
                        self._board.put_signal(f"live:{p}", step)
                    except ValueError:
                        pass  # board reset mid-run: stale-put guard
        for peer, status in self.health.observe(step):
            if status == DEAD:
                self._death_step[peer] = step
                state = self._timed("kill", self._kill, state, peer)

        for f in events:
            if f.kind == "hang":
                self.hangs += 1
                time.sleep(f.seconds)
            elif f.kind == "nan":
                state, batch = self._timed("nan", self._poison_nan, state,
                                           batch, f)
            elif f.kind in ("corrupt", "drop"):
                state = self._timed("guard_round", self._wire_fault, state,
                                    f)
            elif f.kind == "recover":
                state = self._timed("resync", self._recover, state, f, step)

        if events or self.health.peers_dead or self.health.peers_suspect:
            self.rounds_degraded += 1
        return state, batch

    def _timed(self, what: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.event_s.setdefault(what, []).append(time.perf_counter() - t0)
        return out

    # -- fault applicators ---------------------------------------------------
    def _materialize(self, state):
        if self._engine is not None and hasattr(self._engine, "materialize"):
            return self._engine.materialize(state)
        return state

    def _kill(self, state, peer: int):
        """Zero the dead peer's alive mask and redistribute its push-sum
        mass proportionally over the survivors (the ONE host renorm; the
        alive-gated exchange conserves Σ_live w every round after)."""
        state = dict(self._materialize(state))
        mask = self.health.alive_mask()
        w_dev = state["w"]
        w = w_dev.detach().cpu().numpy().copy()
        _renorm(w, peer, mask)
        state["w"] = torch.from_numpy(w).to(w_dev.device)
        state["alive"] = mask
        return state

    def _poison_nan(self, state, batch, f: Fault):
        self.nan_injections += 1
        if self.D > 0 and "fifo" in state:
            state = dict(self._materialize(state))
            g = state["fifo"]["g"]
            names = sorted(g)
            if self.mesh is None:
                g[names[f.group % len(names)]][f.peer, 0] = float("nan")
            elif self.mesh.owner(f.peer) == self.mesh.rank:
                g[names[f.group % len(names)]][
                    self.mesh.local_index(f.peer), 0] = float("nan")
            return state, batch
        if isinstance(batch, dict):
            batch = {k: _poison_rows(v, f.peer) for k, v in batch.items()}
        else:
            batch = _poison_rows(batch, f.peer)
        return state, batch

    def _wire_fault(self, state, f: Fault):
        """One guarded wire round over the read plane: the injected damage
        is detected and repaired from the sealed pristine buffer, so the
        state is bit-exact afterwards; the counters carry the evidence."""
        state = dict(self._materialize(state))
        plane = state["read"]
        names = sorted(plane)
        name = names[f.group % len(names)]
        if self.mesh is not None and self.mesh.owner(0) != self.mesh.rank:
            name = None  # the damage lands on row 0's owner only
        delivered, _ = self.guard.round_trip(
            plane,
            corrupt_group=name if f.kind == "corrupt" else None,
            drop_group=name if f.kind == "drop" else None)
        state["read"] = delivered
        return state

    def _recover(self, state, f: Fault, step: int):
        if self.health.status(f.peer) != DEAD:
            return state  # nothing to recover
        state = dict(self._materialize(state))
        mask = self.health.alive_mask()
        donor = f.donor
        if donor < 0:
            donor = next(p for p in range(self.M)
                         if mask[p] > 0 and p != f.peer)
        state = resync_peer(state, f.peer, donor, self.M, damp=self.damp,
                            mesh=self.mesh)
        self._crashed.discard(f.peer)
        self.health.readmit(f.peer, step)
        self.resyncs += 1
        self._resync_step[f.peer] = step
        state["alive"] = self.health.alive_mask()
        return state

    # -- accounting ----------------------------------------------------------
    def time_to_detect(self) -> Optional[float]:
        """Mean steps from a peer's last beat to its DEAD transition."""
        lat = [self.health.detect_latency(p) for p in self._death_step]
        lat = [v for v in lat if v is not None]
        return float(np.mean(lat)) if lat else None

    def time_to_resync(self) -> Optional[float]:
        """Mean steps a recovered peer spent DEAD before re-admission."""
        spans = [self._resync_step[p] - self._death_step[p]
                 for p in self._resync_step if p in self._death_step]
        return float(np.mean(spans)) if spans else None

    def summary(self) -> Dict[str, object]:
        out = {
            "faults_injected": self.faults_injected,
            "rounds_degraded": self.rounds_degraded,
            "peers_dead": self.health.peers_dead,
            "peers_suspect": self.health.peers_suspect,
            "resyncs": self.resyncs,
            "hangs": self.hangs,
            "nan_injections": self.nan_injections,
        }
        counters = self.guard.counters()
        if self.mesh is not None:
            # every rank seals its rows in the same rounds; the damage and
            # its repair are counted where the damaged row lives
            keys = ("checksum_rejects", "drops_detected", "resends")
            summed = self.mesh.all_reduce_sum_(torch.tensor(
                [float(counters[k]) for k in keys],
                device=self.mesh.resolved_device()))
            counters.update({k: int(v) for k, v in zip(keys,
                                                        summed.tolist())})
        out.update(counters)
        ttd, ttr = self.time_to_detect(), self.time_to_resync()
        if ttd is not None:
            out["time_to_detect_steps"] = ttd
        if ttr is not None:
            out["time_to_resync_steps"] = ttr
        return out
