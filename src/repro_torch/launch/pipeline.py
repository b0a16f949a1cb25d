"""Stage-graph pipeline engine for the decoupled LayUp step (port of the flat
route of ``repro/launch/pipeline.py``, DESIGN.md §10).

The monolithic step (``repro_torch.launch.train``) runs the R forward
slices, the delayed update and the gossip of one step as one call. This
module splits the SAME lane closures, at the same boundaries, into stages::

    fwd-slice r  (read, batch)                    -> losses_r [, grads]
    update       (write, opt, fifo, grads, θ, t)  -> deltas | write',
                                                     opt', fifo', stale,
                                                     skips [, θ']
    gossip       (write, deltas, resid, w,
                  versions, losses, stale,
                  skips, t, s)                    -> mixed, resid', w',
                                                     versions', metrics

(the gossip stage also folds the metrics, so a step is R + 2 stages), and
:class:`PipelineEngine` runs them one after the other on the caller's
current CUDA stream. PyTorch enqueues CUDA work without waiting for it, so
the host returns from ``step`` while the card still runs the step; a step
makes no host synchronisation of its own. Each stage is followed by a
fence, a ``torch.cuda.Event`` recorded on the stream; the
:class:`StageTimeline` stamps the host time at each stage's dispatch, the
stages whose fences were not ready then (``Event.query()``), and the first
time each fence was seen ready. Numerics are identical to the monolithic
step: the same lane closures on the same inputs, in the same stream order.

``streams > 1`` runs the stages on CUDA streams of their own with the
gossip split per layer group (:mod:`repro_torch.launch.streams`).

**Buffers consumed in place** (the reference's donation sets,
``repro/launch/pipeline.py::_jit_stages``). The engine's state is the
monolithic step's dict (``read``/``write``/``opt``/``w``/``versions``
[/``fifo``][/``resid``][/``theta``]); a step consumes it, and callers keep
the returned state only:

* the read plane is never written by a forward slice; all R slices of a
  step read it;
* the update stage updates the optimizer state and the applied FIFO slot in
  place, masks the gradient plane in place (the fifo keeps it as its newest
  slot at D = 1) and writes this step's pre-update params into θ
  (``compensate > 0``); it only reads the write plane. On the fused route
  (``use_pallas``) it returns the update deltas, else a fresh updated plane;
* the gossip stage on the fused route writes the mixed plane into the write
  plane in place, which after the first step is also the read plane: the
  step's forward slices ran before it on the same stream, so stream order
  makes that safe. The int8 residual is rewritten in place; the push-sum
  weights and the version clocks come out fresh. The mixed plane becomes
  both next-step handles (read == write at every step boundary, as in the
  monolithic step).

Membership (``state["alive"]``, the host mask): the engine copies it to
the device while a peer is dead and passes it to the update and gossip
stages, which gate as the monolithic step does; the mask itself passes
through to the next state.

On one stream the caching allocator is stream-ordered, so the engine holds
no buffer past its last use; ``max_inflight_steps`` bounds how many steps
the host may enqueue ahead of the card (it blocks on the oldest step's
fence event, never on a copy to the host).

The Model/mesh factory and ``lower()`` have no counterpart without XLA and
a device mesh (ROADMAP queue 1, item 15).
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.convert import to_torch
from repro_torch.core.layerview import FlatPartition, send_fractions
from repro_torch.core.pytree import tree_map
from repro_torch.device import not_ported, resolve_device
from repro_torch.launch.train import (_check_wire, _decoupled_metrics,
                                      _ring_exchange, alive_on_device,
                                      backward_update_lane,
                                      combine_slice_losses,
                                      forward_slice_lane, gate_update,
                                      gossip_fused_lane, gossip_plane_lane,
                                      live_loss, make_decoupled_state,
                                      stamp_live, straggler_active_fn)
from repro_torch.optim.optimizers import Optimizer


# ---------------------------------------------------------------------------
# fences
# ---------------------------------------------------------------------------


def record_fence(device: torch.device):
    """A fence after the work enqueued so far on the current stream: a
    ``torch.cuda.Event`` recorded there on a CUDA device; ``None`` on the
    CPU, whose work is done when it returns."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _is_ready(fence) -> bool:
    """Non-blocking probe: ``Event.query()``, or ``is_ready()`` of another
    fence object; ``None`` is ready."""
    if fence is None:
        return True
    query = getattr(fence, "query", None)
    return bool(query() if query is not None else fence.is_ready())


def _block(fence) -> None:
    """Wait on the host until the fence's work is done."""
    sync = getattr(fence, "synchronize", None)
    if sync is not None:
        sync()


# ---------------------------------------------------------------------------
# stage timeline: measured dispatch/complete timestamps + overlap accounting
# ---------------------------------------------------------------------------


class StageTimeline:
    """Host-side record of every stage dispatch and stage execution.

    Two kinds of events share the list:

    * **dispatch events** (:class:`PipelineEngine`, via ``begin``/
      ``commit``): ``{stage, step, slice, dispatch, complete,
      concurrent}``. ``dispatch`` is stamped when the host starts the
      stage, ``concurrent`` lists the ``(stage, step, slice)`` triples whose
      fences were NOT ready at that moment (the host ran ahead of the
      card), and ``complete`` is the first time the fence was seen ready
      (polled at later dispatches and at ``finalize()``): an upper bound on
      the true completion.
    * **execution events** (:class:`~repro_torch.launch.streams.
      StreamEngine`, via ``record_exec``): the same shape plus ``{stream,
      enqueue, exec_start, wait_s[, group]}``. ``[exec_start, complete]``
      is the stage's execution span on its stream (on the card: a pair of
      CUDA events around it, placed on the host clock), so spans of
      different streams interleave exactly when the card ran two stages at
      once. ``dispatch`` is set to ``exec_start`` and ``concurrent`` to
      ``[]``; ``wait_s`` is the host time the task spent waiting for its
      inputs' producers before it launched."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []
        self._pending: List[Tuple[Dict[str, Any], Any]] = []

    @property
    def clock(self) -> Callable[[], float]:
        return self._clock

    def begin(self, stage: str, step: int, slice_idx=None) -> Dict[str, Any]:
        """Open an event as the stage starts: timestamp + snapshot of the
        stages still in flight. Pair with :meth:`commit`."""
        now = self._clock()
        self.poll(now)
        concurrent = [(e["stage"], e["step"], e["slice"])
                      for e, _ in self._pending]
        ev = {"stage": stage, "step": int(step), "slice": slice_idx,
              "dispatch": now, "complete": None, "concurrent": concurrent}
        self.events.append(ev)
        return ev

    def commit(self, ev: Dict[str, Any], fence) -> None:
        """Attach the dispatched stage's fence to its event."""
        self._pending.append((ev, fence))
        self.poll()

    def record_exec(self, stage: str, step: int, *, stream: str,
                    enqueue: Optional[float], exec_start: float,
                    complete: float, wait_s: float = 0.0,
                    slice_idx=None, group: Optional[str] = None) -> None:
        """Record one finished stage execution (a closed span). Thread-safe:
        stream threads record while the host reads ``summary``."""
        ev = {"stage": stage, "step": int(step), "slice": slice_idx,
              "dispatch": exec_start, "complete": complete,
              "concurrent": [], "stream": stream, "enqueue": enqueue,
              "exec_start": exec_start, "wait_s": float(wait_s)}
        if group is not None:
            ev["group"] = group
        with self._lock:
            self.events.append(ev)

    def poll(self, now: Optional[float] = None) -> None:
        if not self._pending:
            return
        now = self._clock() if now is None else now
        still = []
        for ev, fence in self._pending:
            if _is_ready(fence):
                ev["complete"] = now
            else:
                still.append((ev, fence))
        self._pending = still

    def finalize(self) -> None:
        """Block on every outstanding fence and close its event."""
        for ev, fence in self._pending:
            _block(fence)
            ev["complete"] = self._clock()
        self._pending = []

    def reset(self) -> None:
        """Drop all recorded events (finalizing outstanding ones first), for
        backends that re-init and measure a fresh run."""
        self.finalize()
        with self._lock:
            self.events = []

    def summary(self) -> Dict[str, Any]:
        """Aggregate the recorded events. Returned fields:

        * ``events``: events recorded (pending ones too); ``steps``:
          ``max(step) + 1`` over closed events; ``wall_s``: first dispatch to
          last completion.
        * ``stage_s``: summed ``complete − dispatch`` per stage name (stages
          overlap, so the values can sum past ``wall_s``).
        * ``overlap_events`` / ``overlap_s``: dispatch-level run-ahead,
          events whose start found any stage still in flight and the summed
          window each overlapped (how far the host ran ahead, not proof of
          concurrent execution).
        * ``fwd_gossip_overlap_s``: step ``t``'s forwards dispatched while
          step ``t−1``'s gossip was in flight, once per adjacent step pair.
        * ``streams``: distinct execution streams that recorded events (1 for
          the single-stream engine).
        * ``exec_overlap_s``: measured execution concurrency: each stream's
          ``[exec_start, complete]`` spans merged into busy intervals, the
          integral of ``(busy_streams − 1)`` over time; zero unless two
          streams executed at the same instant.
        * ``stream_busy_s``: per-stream merged busy time.
        * ``signal_wait_s``: summed time stream tasks waited for their
          inputs' producers before launching."""
        with self._lock:
            events = list(self.events)
        evs = [e for e in events if e["complete"] is not None]
        out: Dict[str, Any] = {
            "events": len(events), "steps": 0, "wall_s": 0.0,
            "overlap_events": 0, "overlap_s": 0.0,
            "fwd_gossip_overlap_s": 0.0, "stage_s": {},
            "streams": 1, "exec_overlap_s": 0.0, "stream_busy_s": {},
            "signal_wait_s": 0.0,
        }
        if not evs:
            return out
        t0 = min(e["dispatch"] for e in evs)
        out["steps"] = max(e["step"] for e in evs) + 1
        out["wall_s"] = max(e["complete"] for e in evs) - t0
        stage_s: Dict[str, float] = {}
        for e in evs:
            stage_s[e["stage"]] = (stage_s.get(e["stage"], 0.0)
                                   + e["complete"] - e["dispatch"])
        out["stage_s"] = stage_s
        index = {(e["stage"], e["step"], e["slice"]): e for e in evs}
        overlap = 0.0
        overlap_events = 0
        # the paper's overlap: step t's forward slices dispatched while step
        # t−1's gossip is still in flight, each gossip counted once, from the
        # EARLIEST forward that found it unretired
        first_fwd: Dict[int, Dict[str, Any]] = {}
        for e in evs:
            window = 0.0
            for key in e["concurrent"]:
                g = index.get(tuple(key))
                if g is None or g["complete"] is None:
                    continue
                window = max(window, min(g["complete"], e["complete"])
                             - e["dispatch"])
                if (e["stage"] == "fwd" and key[0] == "gossip"
                        and key[1] == e["step"] - 1
                        and e["step"] not in first_fwd):
                    first_fwd[e["step"]] = e
            if e["concurrent"]:
                overlap_events += 1
                overlap += max(0.0, window)
        fwd_gossip = 0.0
        for t_step, e in first_fwd.items():
            g = index[("gossip", t_step - 1, None)]
            fwd_gossip += max(0.0, min(g["complete"], e["complete"])
                              - e["dispatch"])
        out["overlap_events"] = overlap_events
        out["overlap_s"] = overlap
        out["fwd_gossip_overlap_s"] = fwd_gossip

        # per-stream execution accounting: merge each stream's spans into
        # busy intervals, then sweep the endpoints counting the DISTINCT
        # busy streams; same-stream pipelining contributes nothing
        sevs = [e for e in evs if e.get("stream")]
        if sevs:
            busy: Dict[str, List[List[float]]] = {}
            for e in sorted(sevs, key=lambda e: e["exec_start"]):
                iv = busy.setdefault(e["stream"], [])
                if iv and e["exec_start"] <= iv[-1][1]:
                    iv[-1][1] = max(iv[-1][1], e["complete"])
                else:
                    iv.append([e["exec_start"], e["complete"]])
            out["streams"] = len(busy)
            out["stream_busy_s"] = {
                n: sum(c - s for s, c in iv) for n, iv in busy.items()}
            out["signal_wait_s"] = sum(e.get("wait_s", 0.0) for e in sevs)
            edges = sorted((t, d) for iv in busy.values()
                           for s, c in iv for t, d in ((s, 1), (c, -1)))
            k, last, exec_overlap = 0, 0.0, 0.0
            for t, d in edges:
                if k > 1:
                    exec_overlap += (t - last) * (k - 1)
                k, last = k + d, t
            out["exec_overlap_s"] = exec_overlap
        return out

    def dump(self, path: str) -> str:
        """Write the events (times relative to the first dispatch) and the
        summary as JSON."""
        s = self.summary()
        with self._lock:
            snap = list(self.events)
        t0 = min((e["dispatch"] for e in snap), default=0.0)
        rel = lambda v: None if v is None else v - t0  # noqa: E731
        events = [{**e,
                   "dispatch": e["dispatch"] - t0,
                   "complete": rel(e["complete"]),
                   "concurrent": [list(c) for c in e["concurrent"]],
                   **({"enqueue": rel(e.get("enqueue")),
                       "exec_start": e["exec_start"] - t0}
                      if "stream" in e else {})}
                  for e in snap]
        with open(path, "w") as f:
            json.dump({"summary": s, "events": events}, f, indent=1)
        return path


# ---------------------------------------------------------------------------
# stage bodies: the monolithic step's lanes split at their boundaries
# ---------------------------------------------------------------------------


def _rows(tree: Dict[str, torch.Tensor], m: int) -> Dict[str, torch.Tensor]:
    return {k: v[m] for k, v in tree.items()}


def _stage_bodies(part: FlatPartition, R: int, M: int, device,
                  fwd_slices: Sequence[Callable], upd: Callable,
                  mix: Callable, shifts: Sequence[int], *,
                  active_fn: Optional[Callable] = None, fused: bool = False,
                  wire: str = "param"):
    """The stage bodies, over the SAME lane closures as
    ``launch.train._decoupled_worker_fn``, each the span of the monolithic
    step it replaces:

    * ``fwd[r](read, batch) -> (losses, grads)``: forward slice ``r`` of
      every worker in turn; ``losses`` the M per-worker 0-d losses, and for
      slice 0 ``grads``, each worker's gradients packed into its row of a
      stacked gradient plane (``None`` for ``r > 0``);
    * ``update(write, opt, fifo, grads, theta, step_idx, alive=None)``:
      the update lane's tuple (deltas or updated plane, opt, fifo,
      staleness, skips [, θ']);
    * ``gossip(write, lane_out, resid, w, versions, step_idx, shift_idx,
      out=None, alive=None) -> (mixed, resid, w, versions)``: the gossip
      lane, then the clock stamp ``t + φ_g``; ``out`` is where the fused
      route writes the mixed plane (in place when ``None``);
    * ``mix_group(name, x, lane_out, resid, w, shift_idx, out, alive)``:
      the gossip lane on the one-group sub-dict ``{name: ...}``: the same
      elementwise math as the full-plane stage, and the weight exchange
      recomputed (the stream engine's per-group stage);
    * ``clock(w, versions, step_idx, shift_idx, alive=None) -> (w,
      versions)``: the push-sum weight exchange once more and the stamp;
    * ``metrics(losses, w, versions, stale, step_idx, skips, alive=None,
      mask=None)``: each worker's loss combined in the monolithic order,
      then the mean over workers (the live ones), and the staleness
      metrics (``peers_live`` from the host ``mask``).

    ``alive`` is the device membership mask while a peer is dead
    (:func:`~repro_torch.launch.train.alive_on_device`), else ``None``:
    the same gates as the monolithic step's, at the same points (a dead
    peer's update selected away in the update stage, the gated hop, the
    frozen clocks and the live loss)."""
    int8 = wire == "int8"
    phi = torch.from_numpy(send_fractions(part.num_groups)).to(device)

    def make_fwd_body(r):
        lane = fwd_slices[r]

        def fwd_body(read, batch):
            grads = ({k: torch.empty_like(v) for k, v in read.items()}
                     if r == 0 else None)
            losses = []
            for m in range(M):
                loss_m, g_m = lane(part.unpack(_rows(read, m)),
                                   _rows(batch, m))
                if grads is not None:
                    part.pack(g_m, out=_rows(grads, m))
                del g_m
                losses.append(loss_m)
            return losses, grads

        return fwd_body

    def update_body(write, opt_state, fifo, grads, theta, step_idx,
                    alive=None):
        active = active_fn(step_idx) if active_fn is not None else None
        out = upd(write, opt_state, grads, fifo, step_idx, active=active,
                  theta=theta)
        if alive is None:
            return out
        return (gate_update(out[0], None if fused else write, alive),) \
            + tuple(out[1:])

    def stamp(versions, step_idx, alive):
        if M == 1:  # one worker receives nothing
            return versions
        return stamp_live(versions, phi + float(np.float32(step_idx)), alive)

    def run_mix(write, lane_out, resid, w, shift_idx, out, alive):
        if fused and int8:
            return mix(write, resid, lane_out, w, shift_idx, out=out,
                       alive=alive)
        if fused:
            return mix(write, lane_out, w, shift_idx, out=out,
                       alive=alive) + (None,)
        if int8:
            return mix(lane_out, resid, w, shift_idx, alive=alive)
        return mix(lane_out, w, shift_idx, alive=alive) + (None,)

    def gossip_body(write, lane_out, resid, w, versions, step_idx,
                    shift_idx, out=None, alive=None):
        mixed, a, b = run_mix(write, lane_out, resid, w, shift_idx, out,
                              alive)
        resid, w = (a, b) if int8 else (None, a)
        return mixed, resid, w, stamp(versions, step_idx, alive)

    def mix_group(name, x, lane_out, resid, w, shift_idx, out=None,
                  alive=None):
        one = lambda v: None if v is None else {name: v}  # noqa: E731
        mixed, a, _ = run_mix(one(x), one(lane_out), one(resid), w,
                              shift_idx, one(out), alive)
        return mixed[name], (a[name] if int8 else None)

    def clock_body(w, versions, step_idx, shift_idx, alive=None):
        if M > 1:
            _, w_keep, rw, _ = _ring_exchange(w, shift_idx, shifts, alive)
            w = w_keep + rw
        return w, stamp(versions, step_idx, alive)

    def metrics_fn(losses, w, versions, upd_stale, step_idx, skips,
                   alive=None, mask=None):
        per_worker = [combine_slice_losses(losses[0][m],
                                           [lr[m] for lr in losses[1:]], R)
                      for m in range(M)]
        return _decoupled_metrics(w, versions, live_loss(per_worker, alive),
                                  upd_stale, step_idx, skips, mask)

    return {"fwd": [make_fwd_body(r) for r in range(R)],
            "update": update_body, "gossip": gossip_body,
            "mix_group": mix_group, "clock": clock_body,
            "metrics": metrics_fn}


def _make_stages(bodies) -> Dict[str, Any]:
    """The single-stream engine's stages (``no_grad``, as the monolithic
    ``step_fn``; slice 0 enables grad inside its lane). The gossip stage
    folds the metrics: ``gossip(write, lane_out, resid, w, versions,
    losses, stale, skips, step_idx, shift_idx, alive=None, mask=None) ->
    (mixed, resid, w, versions, metrics)``."""
    gossip, metrics_fn = bodies["gossip"], bodies["metrics"]

    def gossip_stage(write, lane_out, resid, w, versions, losses, upd_stale,
                     skips, step_idx, shift_idx, alive=None, mask=None):
        mixed, resid, w, versions = gossip(write, lane_out, resid, w,
                                           versions, step_idx, shift_idx,
                                           alive=alive)
        metrics = metrics_fn(losses, w, versions, upd_stale, step_idx, skips,
                             alive, mask)
        return mixed, resid, w, versions, metrics

    ng = torch.no_grad()
    return {"fwd": [ng(f) for f in bodies["fwd"]],
            "update": ng(bodies["update"]), "gossip": ng(gossip_stage)}


def _make_group_stages(bodies, group_names: Sequence[str]) -> Dict[str, Any]:
    """The gossip stage split at the layer-group boundary, for the stream
    engine: ``mix[g](x, lane_out, resid, w, shift_idx, out, alive) ->
    (mixed, resid)`` per plane buffer, and ``clock(w, versions, losses,
    stale, skips, step_idx, shift_idx, alive, mask) -> (w, versions,
    metrics)``. Together they compute what the single-stream gossip stage
    computes."""
    mix_group, clock, metrics_fn = (bodies["mix_group"], bodies["clock"],
                                    bodies["metrics"])
    ng = torch.no_grad()

    def make_mix(name):
        return ng(lambda x, lane_out, resid, w, shift_idx, out=None,
                  alive=None: mix_group(name, x, lane_out, resid, w,
                                        shift_idx, out, alive))

    def clock_stage(w, versions, losses, upd_stale, skips, step_idx,
                    shift_idx, alive=None, mask=None):
        w, versions = clock(w, versions, step_idx, shift_idx, alive)
        return w, versions, metrics_fn(losses, w, versions, upd_stale,
                                       step_idx, skips, alive, mask)

    return {"mix": {g: make_mix(g) for g in group_names},
            "clock": ng(clock_stage)}


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class PipelineEngine:
    """Owns the stages, the in-flight fences and the timeline.

    ``step(state, batch, step_idx, shift_idx) -> (state, metrics)`` keeps
    the monolithic step's signature and state layout. The stages run on the
    caller's current CUDA stream and ``step`` returns once they are
    enqueued; reading a metric on the host waits for that value only."""

    def __init__(self, *, R: int, D: int, M: int, stages: Dict[str, Any],
                 device, timeline: Optional[StageTimeline] = None,
                 describe: str = "", abstract_args=None,
                 max_inflight_steps: int = 3, fused: bool = False,
                 wire: str = "param", compensate: float = 0.0):
        self.R, self.D, self.M = int(R), int(D), int(M)
        self.device = torch.device(device)
        self.fused = bool(fused)
        self.wire = wire
        self.compensate = float(compensate)
        self._stages = stages
        self.timeline = timeline if timeline is not None else StageTimeline()
        self.describe = describe
        # the stages' argument signatures (:func:`flat_abstract_args`), or a
        # callable that makes them on first use (:func:`cutout_args`)
        self.abstract_args = abstract_args or {}
        # fences of the steps in flight, oldest first, each with what the
        # step must keep alive until it retires: nothing on one stream (the
        # caching allocator is stream-ordered). ``max_inflight_steps`` is
        # the backpressure bound: the host blocks on the oldest step's
        # fence rather than run further ahead.
        self.max_inflight_steps = int(max_inflight_steps)
        self._graveyard: List[Tuple[Any, Any]] = []
        self._masks: Dict[tuple, torch.Tensor] = {}  # device alive masks

    def _prune(self) -> None:
        self._graveyard = [(f, h) for f, h in self._graveyard
                           if not _is_ready(f)]

    def step(self, state, batch, step_idx, shift_idx):
        """Enqueue one step: the R forward slices, the update and the gossip
        (+ metrics) stage, each followed by its fence. Returns ``(new_state,
        metrics)`` without waiting for the card."""
        tl = self.timeline
        t, sh = int(step_idx), int(shift_idx)
        mask = state.get("alive")  # membership: the host mask
        alive = alive_on_device(mask, self.device, self._masks)
        self._prune()
        while len(self._graveyard) >= self.max_inflight_steps:
            _block(self._graveyard.pop(0)[0])
            self._prune()

        # forward lane: all R slices read the same plane
        losses, grads = [], None
        for r, fwd in enumerate(self._stages["fwd"]):
            ev = tl.begin("fwd", t, slice_idx=r)
            loss_r, g = fwd(state["read"], batch)
            tl.commit(ev, record_fence(self.device))
            losses.append(loss_r)
            if r == 0:
                grads = g
            del g

        ev = tl.begin("update", t)
        upd_out = self._stages["update"](
            state["write"], state["opt"], state.get("fifo", ()), grads,
            state.get("theta"), t, alive)
        del grads
        lane_out, opt, fifo, upd_stale, skips = upd_out[:5]
        theta = upd_out[5] if len(upd_out) > 5 else None
        del upd_out
        tl.commit(ev, record_fence(self.device))

        ev = tl.begin("gossip", t)
        mixed, resid, w, versions, metrics = self._stages["gossip"](
            state["write"], lane_out, state.get("resid"), state["w"],
            state["versions"], losses, upd_stale, skips, t, sh, alive, mask)
        del lane_out
        fence = record_fence(self.device)
        tl.commit(ev, fence)
        self._graveyard.append((fence, None))

        new_state = {"read": mixed, "write": mixed, "opt": opt, "w": w,
                     "versions": versions}
        if self.D > 0:
            new_state["fifo"] = fifo
        if resid is not None:
            new_state["resid"] = resid
        if theta is not None:
            new_state["theta"] = theta
        if mask is not None:
            new_state["alive"] = mask
        return new_state, metrics

    def reset(self) -> None:
        """Prepare for a fresh measured run: finalize and drop the
        timeline's events, then release the in-flight fences."""
        self.timeline.reset()
        self._graveyard = []

    def stage_cutouts(self) -> Dict[str, Tuple[Any, tuple]]:
        """Every stage paired with the abstract arguments to make its inputs
        from (:func:`flat_abstract_args`): the autotuner's extraction point
        (ROADMAP queue 1, item 12). Keys: ``fwd0..fwdR-1``, ``update``,
        ``gossip``. Raises until the first step recorded the batch's
        signature."""
        args = cutout_args(self)
        out = {}
        for r, f in enumerate(self._stages["fwd"]):
            out[f"fwd{r}"] = (f, args["fwd"])
        for name in ("update", "gossip"):
            out[name] = (self._stages[name], args[name])
        return out

    def lower(self):
        raise not_ported("lowering stages (an XLA notion)", 15)


def cutout_args(engine) -> Dict[str, tuple]:
    """An engine's abstract args, checked for cutting stages out. Given as
    a callable, they are made here, on first use: making them runs the
    optimizer on meta tensors, whose first use in a process imports much of
    torch, and that import leaves a reference cycle holding the calling
    frames; inside a training step those frames hold the whole state."""
    if callable(engine.abstract_args):
        engine.abstract_args = engine.abstract_args()
    args = engine.abstract_args
    if not args:
        raise ValueError("engine has no abstract args to cut stages out "
                         "against")
    if args["fwd"][-1] is None:
        raise ValueError("forward batch abstract unknown: step the engine "
                         "once so the backend path records the batch "
                         "signature")
    return args


@dataclass
class PipelineStep:
    """The engine behind a step function: ``fn(state, batch, step_idx,
    shift_idx)`` like the monolithic decoupled step, ``init_state`` builds
    its state."""
    engine: Any
    init_state: Callable
    describe: str = ""

    def fn(self, state, batch, step_idx, shift_idx):
        return self.engine.step(state, batch, step_idx, shift_idx)

    def lower(self):
        return self.engine.lower()

    @property
    def timeline(self) -> StageTimeline:
        return self.engine.timeline


# ---------------------------------------------------------------------------
# abstract signatures and the factory
# ---------------------------------------------------------------------------


def _spec(t: torch.Tensor) -> Tuple[Tuple[int, ...], torch.dtype]:
    return tuple(t.shape), t.dtype


def flat_abstract_args(part: FlatPartition, optimizer: Optimizer, M: int,
                       R: int, D: int, *, batch_abs=None,
                       fused: bool = False, wire: str = "param",
                       compensate: float = 0.0,
                       groups: bool = False) -> Dict[str, tuple]:
    """The argument signature of every stage, keyed like the engines'
    ``abstract_args`` (``"fwd"``/``"update"``/``"gossip"``, plus
    ``"mix:{group}"``/``"clock"`` with ``groups=True``, the stream
    engine's). Each tensor is a ``(shape, dtype)`` pair, a host integer
    the type ``int``, an absent argument ``None``. Optimizer shapes come
    from running it on meta tensors (nothing is allocated).
    ``batch_abs=None`` leaves a placeholder the backend fills from the
    first batch it sees."""
    meta = {g: torch.empty((M, n), dtype=part.group_dtypes[g],
                           device="meta")
            for g, n in part.group_sizes.items()}
    plane = tree_map(_spec, meta)
    opt_meta = optimizer.init(meta)
    opt = tree_map(_spec, opt_meta)
    f32 = ((), torch.float32)
    w_abs = ((M,), torch.float32)
    v_abs = ((M, part.num_groups), torch.float32)
    losses_abs = tuple(tuple(f32 for _ in range(M)) for _ in range(R))
    fifo = ()
    if D > 0:
        fifo = {"g": {g: ((M, D, n), part.group_dtypes[g])
                      for g, n in part.group_sizes.items()},
                "stamp": ((D,), torch.float32)}
    upd = (tree_map(_spec, optimizer.update(meta, opt_meta, meta, 0.1)[0])
           if fused else plane)
    resid = plane if wire == "int8" else None
    theta = plane if float(compensate) > 0.0 else None
    out = {
        "fwd": (plane, batch_abs),
        "update": (plane, opt, fifo, plane, theta, int),
        "gossip": (plane, upd, resid, w_abs, v_abs, losses_abs, f32, f32,
                   int, int),
    }
    if groups:
        for g in part.group_sizes:
            out[f"mix:{g}"] = (plane[g], upd[g], None if resid is None
                               else resid[g], w_abs, int,
                               plane[g] if fused else None)
        out["clock"] = (w_abs, v_abs, losses_abs, f32, f32, int, int)
    return out


def make_layup_decoupled_pipeline(*args, **kwargs):
    """The reference's Model/mesh factory: jit-level shardings on a device
    mesh, which the port has no counterpart for yet."""
    raise not_ported("the Model/mesh pipeline factory", 15)


def make_pipeline_backend_trainer(loss_fn: Callable, optimizer: Optimizer,
                                  schedule: Callable, M: int, *,
                                  device=None,
                                  shifts: Sequence[int] = (1, 2, 4, 8),
                                  fb_ratio: int = 1, update_delay: int = 0,
                                  straggler_delays=None,
                                  measure_drift: bool = False,
                                  timeline: Optional[StageTimeline] = None,
                                  flat: bool = True,
                                  use_pallas: bool = False,
                                  publisher=None,
                                  streams: int = 1, wire: str = "param",
                                  compensate: float = 0.0,
                                  membership: bool = False,
                                  max_inflight_steps: Optional[int] = None,
                                  wait_timeout_s: float = 600.0):
    """Pipeline-engine counterpart of
    ``launch.train.make_decoupled_backend_trainer``: the same params dict +
    ``loss_fn`` contract and sim-layout batches (a leading ``(M,)`` worker
    axis on every leaf), with the step run by the stage-graph engine.

    ``streams > 1`` swaps in :class:`repro_torch.launch.streams.
    StreamEngine`: the same forward and update stages plus the gossip stage
    split per layer group, on CUDA streams of their own. ``wait_timeout_s``
    bounds every wait of its threads (a lost signal raises, never hangs).
    ``membership`` adds the alive mask to the state (DESIGN.md §15); the
    engines thread it into the update and gossip stages.

    ``publisher`` (a :class:`repro_torch.serving.PlanePublisher`, with
    ``streams=1``) receives the read plane after every step. Unlike the
    reference's engine, this one writes its read plane in place (the fused
    gossip stage mixes into it), so the publish is ``stable=False``: the
    publisher copies the plane on the device, on the engine's stream.

    Returns ``(init_fn, step_fn, shifts, box)``: ``box["engine"]`` holds
    the engine and ``box["part"]`` the FlatPartition once ``init_fn`` has
    seen the params."""
    if not flat:
        raise not_ported("flat=False (the legacy per-leaf tree state)", 15)
    if streams > 1 and publisher is not None:
        raise ValueError("publisher is not supported with streams > 1: "
                         "the stream engine's read plane is a future, not "
                         "a stable handle to publish (serve from a "
                         "streams=1 engine, or materialize snapshots)")
    _check_wire(wire, compensate)
    device = resolve_device(device)
    R, D = int(fb_ratio), int(update_delay)
    shifts = tuple(s % M for s in shifts if s % M != 0) or (1,)
    active_fn = straggler_active_fn(M, straggler_delays, device)
    inflight = ({} if max_inflight_steps is None
                else {"max_inflight_steps": int(max_inflight_steps)})
    tags = (f"{', pallas' if use_pallas else ''}"
            f"{', wire=int8' if wire == 'int8' else ''}"
            f"{f', comp={float(compensate):g}' if compensate else ''}")
    box: Dict[str, Any] = {}

    def build(params_single):
        part = FlatPartition(params_single)
        fwd_slices = [forward_slice_lane(loss_fn, fb_ratio=R, slice_idx=r)
                      for r in range(R)]
        upd = backward_update_lane(optimizer, schedule, update_delay=D,
                                   apply=not use_pallas,
                                   compensate=compensate)
        mix = (gossip_fused_lane(part, M, shifts, wire=wire) if use_pallas
               else gossip_plane_lane(part, M, shifts, wire=wire))
        bodies = _stage_bodies(part, R, M, device, fwd_slices, upd, mix,
                               shifts, active_fn=active_fn,
                               fused=use_pallas, wire=wire)
        def absargs():
            return flat_abstract_args(part, optimizer, M, R, D,
                                      batch_abs=box.get("batch_abs"),
                                      fused=use_pallas, wire=wire,
                                      compensate=compensate,
                                      groups=streams > 1)
        common = dict(R=R, D=D, M=M, stages=_make_stages(bodies),
                      device=device, timeline=timeline, fused=use_pallas,
                      wire=wire, compensate=compensate,
                      abstract_args=absargs, **inflight)
        if streams > 1:
            from repro_torch.launch.streams import StreamEngine
            engine = StreamEngine(
                group_names=list(part.group_sizes),
                group_stages=_make_group_stages(bodies, part.group_sizes),
                n_streams=streams, wait_timeout_s=wait_timeout_s,
                describe=(f"stream pipeline backend (M={M}, R={R}, D={D}, "
                          f"streams={streams}, "
                          f"groups={len(part.group_sizes)}{tags})"),
                **common)
        else:
            engine = PipelineEngine(
                describe=(f"pipeline backend (M={M}, R={R}, D={D}, "
                          f"flat=True{tags})"), **common)
        return engine, part

    def init_fn(rng, params_single):
        del rng
        params_single = to_torch(params_single, device)
        stacked = tree_map(lambda p: p[None].expand((M,) + tuple(p.shape)),
                           params_single)
        if "engine" not in box:
            box["engine"], box["part"] = build(params_single)
        return make_decoupled_state(stacked, optimizer, update_delay=D,
                                    part=box["part"], wire=wire,
                                    compensate=compensate,
                                    membership=membership)

    def step_fn(state, batch, step_idx, shift_idx):
        if "engine" not in box:
            raise RuntimeError("call init_fn before step_fn")
        eng = box["engine"]
        batch = to_torch(batch, device)
        if "batch_abs" not in box:
            # the forward batch signature, learnt from the first batch
            box["batch_abs"] = tree_map(_spec, batch)
            if isinstance(eng.abstract_args, dict) and eng.abstract_args:
                eng.abstract_args["fwd"] = (eng.abstract_args["fwd"][0],
                                            box["batch_abs"])
        state, metrics = eng.step(state, batch, step_idx, shift_idx)
        if measure_drift:
            from repro_torch.core.api import disagreement
            drift = torch.no_grad()(disagreement)
            if streams > 1:
                # on the gossip stream after the step's clock
                metrics["disagreement"] = eng.submit_aux(
                    "drift", drift, (state["read"], state["w"]),
                    int(step_idx))
            else:
                metrics["disagreement"] = drift(state["read"], state["w"])
        if publisher is not None:
            publisher.publish(state["read"], state["versions"], state["w"],
                              int(step_idx),
                              drift=metrics.get("disagreement"),
                              stable=False)
        return state, metrics

    return init_fn, step_fn, shifts, box
