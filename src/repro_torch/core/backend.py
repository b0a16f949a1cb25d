"""The prod TrainerBackend on one CUDA device (port of the ``"prod"`` kind
of ``repro/core/backend.py``).

``ProdTrainerBackend`` runs the decoupled PD-ASGD step of
``repro_torch.launch.train`` behind the one-step-per-iteration protocol:
``init(rng, params_single) → state`` then ``step(state, batch, rng) →
(state, metrics)``, plus ``summary()``. Batches use the sim layout (leading
``(M,)`` worker axis). The M workers are stacked on one device, the
reference's mesh of M devices. The per-step gossip shift is drawn by a host
numpy generator seeded at init, the same draws as the reference's.

Metrics are device tensors (with ``streams > 1``, futures of them);
``summary()`` and ``drive``'s history read them on the host.

``faults=`` (a spec string or a ``FaultPlan``; ``""`` is the empty plan)
turns on membership and chaos injection (``repro_torch.chaos``, DESIGN.md
§15): a fresh ``ChaosController`` per ``init`` applies the plan's faults
at the host step boundary before each step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np

from repro_torch.device import not_ported, resolve_device
from repro_torch.launch.pipeline import (StageTimeline,
                                         make_pipeline_backend_trainer)
from repro_torch.launch.train import make_decoupled_backend_trainer

_NUMERIC_SUMMARY_KEYS = ("loss", "disagreement", "staleness_mean",
                         "update_staleness", "weight_sum", "nonfinite_skips",
                         "peers_live")


def _numeric_summary(steps: int, last: Dict[str, Any]) -> Dict[str, float]:
    out = {"steps": float(steps)}
    for k in _NUMERIC_SUMMARY_KEYS:
        if k in last:
            out[k] = float(last[k])
    return out


def _add_skips(total, skips):
    return skips.clone() if total is None else total + skips


class ProdTrainerBackend:
    """The decoupled LayUp lane with M workers stacked on one device.

    Keyword arguments keep the reference's names so a call ports one to
    one. ``use_pallas=True`` is the fused Alg. 1 route through the kernels
    (``gossip_mix``; with ``wire="int8"`` at M > 1, ``quantize_plane`` and
    ``dequant_mix``); the default applies each update and then mixes in
    plain PyTorch. ``wire="int8"`` ships the gossip plane as int8 with
    per-row f32 scales and error-feedback residuals; ``compensate=λ > 0``
    applies the delay correction ``g + λ·g⊙g⊙(θ_now − θ_stale)`` in the
    update lane (DESIGN.md §14); ``summary()`` reports ``wire_dtype`` and
    ``wire_bytes_per_round``. ``device`` (default ``"cuda"``, which must
    exist) replaces the reference's ``mesh``.

    ``overlap=True`` runs the step through the stage-graph pipeline engine
    (``repro_torch.launch.pipeline``; ``max_inflight_steps`` bounds the
    steps enqueued ahead of the card), and ``streams > 1`` through the
    stream engine on CUDA streams of their own
    (``repro_torch.launch.streams``; ``wait_timeout_s`` bounds each wait of
    its threads): the same numerics, and ``summary()`` adds the measured
    stage timeline's overlap fields.

    ``faults`` (a spec string or a ``FaultPlan``) turns on fault-tolerant
    membership on any of the three routes and either wire: crash, hang,
    nan, corrupt, drop and recover events replayed by a
    ``repro_torch.chaos.ChaosController`` before each step, the alive-gated
    step while a peer is dead, ``peers_live`` in the metrics, and the
    controller's counters (with a cumulative ``nonfinite_skips``) in
    ``summary()``. ``faults=""`` injects nothing and gives the same bits as
    ``faults=None``. The options still to port (``mesh``, ``flat=False``,
    ``publisher``, ``tuning``) raise ``NotImplementedError`` naming the
    ROADMAP item that ports them."""

    kind = "prod"

    def __init__(self, algo, loss_fn: Callable, optimizer, schedule,
                 M: int, *, device=None, mesh=None, shifts=(1, 2, 4, 8),
                 fb_ratio: int = 1, update_delay: int = 0,
                 straggler_delays=None, measure_drift: bool = True,
                 overlap: bool = False, flat: bool = True,
                 use_pallas: bool = False, publisher=None,
                 streams: int = 1, wire: str = "param",
                 compensate: float = 0.0, faults=None,
                 max_inflight_steps=None, tuning=None,
                 wait_timeout_s: float = 600.0):
        if mesh is not None:
            raise not_ported("an explicit device mesh (multi-GPU ring)", 15)
        if int(streams) > 1 and not overlap:
            raise ValueError("streams > 1 is a property of the stage-graph "
                             "pipeline; it requires overlap=True")
        if publisher is not None:
            raise not_ported("publisher (live serving)", 11)
        if tuning is not None:
            raise not_ported("tuning (the stage autotuner)", 12)
        if not flat:
            raise not_ported("flat=False (the legacy per-leaf tree state)",
                             15)
        algo_name = getattr(algo, "name", str(algo))
        if not algo_name.startswith("layup"):
            raise ValueError(
                f"prod backend implements the layup family only, not "
                f"{algo_name!r} (the gossip ring is the algorithm)")
        self.name = f"prod:{algo_name}"
        self.M = M
        self.wire = str(wire)
        self.streams = int(streams)
        self.compensate = float(compensate)
        self.update_delay = int(update_delay)
        self.device = resolve_device(device)
        self.membership = faults is not None
        self._faults = faults
        self.chaos = None
        self._nonfinite_total = None
        if self.membership:
            # built here so that a malformed plan fails now, not at a step;
            # init() makes a fresh controller for each run
            self.chaos = self._controller()
        common = dict(device=self.device, shifts=shifts, fb_ratio=fb_ratio,
                      update_delay=update_delay,
                      straggler_delays=straggler_delays,
                      measure_drift=measure_drift, use_pallas=use_pallas,
                      wire=wire, compensate=compensate,
                      membership=self.membership)
        if overlap:
            self.timeline = StageTimeline()
            self._init_fn, self._step_fn, self._shifts, self._engine_box = \
                make_pipeline_backend_trainer(
                    loss_fn, optimizer, schedule, M, timeline=self.timeline,
                    streams=self.streams,
                    max_inflight_steps=max_inflight_steps,
                    wait_timeout_s=wait_timeout_s, **common)
        else:
            self.timeline = None
            self._init_fn, self._step_fn, self._shifts, self._engine_box = \
                make_decoupled_backend_trainer(loss_fn, optimizer, schedule,
                                               M, **common)
        self._steps = 0
        self._last: Dict[str, Any] = {}
        self._shift_rng = np.random.default_rng(0xC0FFEE)

    def _controller(self):
        from repro_torch.chaos import ChaosController
        return ChaosController(self._faults, self.M,
                               update_delay=self.update_delay,
                               compensate=self.compensate)

    @property
    def engine(self):
        """The pipeline or stream engine (``overlap=True``, after init);
        else None."""
        return self._engine_box.get("engine")

    @property
    def part(self):
        """The FlatPartition fixing the state's plane layout (after init)."""
        return self._engine_box.get("part")

    def export_params(self, state):
        """Stacked ``(M, ...)`` parameter tree view of the read plane (the
        stream engine's futures materialized first)."""
        part = self._engine_box.get("part")
        if part is None:
            raise RuntimeError("call init() before export_params()")
        read = state["read"]
        if self.streams > 1:
            read = self.engine.materialize(read)
        return part.unpack(read)

    def init(self, rng, params_single):
        self._steps = 0
        self._shift_rng = np.random.default_rng(0xC0FFEE)
        if self.engine is not None:
            # a re-init measures a fresh run: stale events would collide in
            # the overlap accounting's event index
            self.engine.reset()
        elif self.timeline is not None:
            self.timeline.reset()
        state = self._init_fn(rng, params_single)
        if self.membership:
            # a fresh controller per run (fault replay and health are per
            # run), hooked to the engine so that a host mutation first
            # materializes the stream engine's futures, and to its board so
            # that the liveness beats land there
            self.chaos = self._controller()
            self._nonfinite_total = None
            eng = self.engine
            self.chaos.attach(engine=eng, board=getattr(eng, "board", None))
        return state

    def step(self, state, batch, rng=None):
        # ``rng`` belongs to the TrainerBackend protocol; the ring's shift
        # schedule is drawn host-side
        if self.chaos is not None:
            state, batch = self.chaos.before_step(state, batch, self._steps)
        shift_idx = int(self._shift_rng.integers(0, len(self._shifts)))
        state, metrics = self._step_fn(state, batch, self._steps, shift_idx)
        if self.chaos is not None:
            # the run's skips for summary() (a transient NaN's metric is 0
            # again by the end), summed on the device without a wait: a
            # stream engine's future is summed by a task of its own
            skips = metrics["nonfinite_skips"]
            if hasattr(skips, "result"):
                self._nonfinite_total = self.engine.submit_aux(
                    "skips", _add_skips, (self._nonfinite_total, skips),
                    self._steps)
            else:
                self._nonfinite_total = _add_skips(self._nonfinite_total,
                                                   skips)
        self._steps += 1
        self._last = metrics
        return state, metrics

    def summary(self) -> Dict[str, float]:
        out = _numeric_summary(self._steps, self._last)
        out["wire_dtype"] = self.wire
        part = self._engine_box.get("part")
        if part is not None:
            # one full plane crosses the ring per gossip round per worker
            out["wire_bytes_per_round"] = float(
                part.plane_nbytes(wire=self.wire))
        if self.timeline is not None:
            if self.streams > 1 and self.engine is not None:
                self.engine.finalize()  # retire the in-flight tasks
            self.timeline.finalize()
            t = self.timeline.summary()
            out.update(pipeline_wall_s=t["wall_s"],
                       overlap_events=float(t["overlap_events"]),
                       overlap_s=t["overlap_s"],
                       fwd_gossip_overlap_s=t["fwd_gossip_overlap_s"],
                       streams=float(t["streams"]),
                       exec_overlap_s=t["exec_overlap_s"],
                       signal_wait_s=t["signal_wait_s"])
        if self.chaos is not None:
            out.update(self.chaos.summary())
            # over the whole run, not the last step's
            out["nonfinite_skips"] = (0.0 if self._nonfinite_total is None
                                      else float(self._nonfinite_total))
        return out


def make_backend(kind: str, algo, *, M: int, loss_fn: Callable = None,
                 optimizer=None, schedule=None, **kw) -> ProdTrainerBackend:
    """Entry point over the backends. The port has ``kind="prod"`` so far
    (needs loss_fn, optimizer, schedule; ``device`` defaults to CUDA)."""
    if kind in ("sim", "event"):
        raise not_ported(f"the {kind!r} backend", 13)
    if kind == "prod":
        if loss_fn is None or optimizer is None or schedule is None:
            raise ValueError("prod backend needs loss_fn, optimizer, schedule")
        return ProdTrainerBackend(algo, loss_fn, optimizer, schedule, M, **kw)
    raise ValueError(
        f"unknown backend kind {kind!r}; use 'sim', 'event' or 'prod'")


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def drive(backend, batches, rng=None, params_single=None,
          history_keys: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """Run a backend over an iterable of batches; collect metric history.

    Returns {"state": final_state, "history": {key: np.ndarray}, and the
    backend's summary() entries}. Reading a history key copies that metric
    to the host after each step."""
    state = backend.init(rng, params_single)
    hist: Dict[str, list] = {k: [] for k in history_keys}
    for batch in batches:
        state, metrics = backend.step(state, batch, rng)
        for k in history_keys:
            if k in metrics:
                hist[k].append(_host(metrics[k]))
    out: Dict[str, Any] = {"state": state,
                           "history": {k: np.asarray(v)
                                       for k, v in hist.items()}}
    out.update(backend.summary())
    return out
