"""TrainerBackend — one protocol over the port's three execution backends
(port of ``repro/core/backend.py``).

* the **sim trainer** (``repro_torch.core.api.make_sim_trainer``): real
  numerics, any registered algorithm, M workers stacked on one device;
  losses, drift and staleness metrics;
* the **event-driven simulator** (``repro_torch.core.simulator``): no
  numerics, the wall-clock schedule (barriers, NIC serialization,
  decoupled lanes); iteration times, utilization and MFU;
* the **prod decoupled lane** (``repro_torch.launch.train``): the PD-ASGD
  step of the layup family, the M workers stacked on one CUDA device, or
  spread over the ranks of a ``torch.distributed`` group (``mesh=``).

All three follow the :class:`TrainerBackend` protocol: ``init(rng,
params_single) → state``, then ``step(state, batch, rng) → (state,
metrics)`` once per update iteration, and ``summary()``.
``make_backend(kind, algo, ...)`` is the one entry point, and ``drive``
runs any of them over a sequence of batches. Batches use the sim layout
(leading ``(M,)`` worker axis) on every numeric backend.

Metrics are device tensors (the stream engine's: futures of them);
``summary()`` and ``drive``'s history read them on the host.

``ProdTrainerBackend``: the per-step gossip shift is drawn by a host numpy
generator seeded at init, the same draws as the reference's. ``faults=``
(a spec string or a ``FaultPlan``; ``""`` is the empty plan) turns on
membership and chaos injection (``repro_torch.chaos``, DESIGN.md §15).
``tuning=`` (a ``TuningRecord`` or the path of one,
``repro_torch.launch.tuner``) replaces the hand-picked schedule defaults
(DESIGN.md §16).
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, Optional, Protocol, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.core.api import (DistAlgorithm, get_algorithm,
                                  make_sim_trainer)
from repro_torch.core.simulator import EventSimulator, HardwareModel, SimResult
from repro_torch.device import resolve_device
from repro_torch.launch.pipeline import make_pipeline_backend_trainer
from repro_torch.launch.timeline import StageTimeline
from repro_torch.launch.train import make_decoupled_backend_trainer

# event-time model for algorithms whose numeric semantics differ from their
# schedule: block-mode LayUp times like GoSGD, hypercube like LayUp
_EVENT_ALIAS = {"layup-block": "gosgd", "layup-hypercube": "layup"}

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


def _check_mesh(mesh, M: int, device):
    """``(ring, device)`` of the prod backend's ``mesh``: ``(None,
    device)`` without one; else a ``WorkerMesh`` of ``M`` workers, whose
    device wins (``None`` is CUDA) and must agree with ``device`` where
    both are given. ``ring`` is the mesh when it has a process group, else
    ``None`` (the one-process layout)."""
    from repro_torch.launch.mesh import WorkerMesh

    if mesh is None:
        return None, device
    if not isinstance(mesh, WorkerMesh):
        raise TypeError(f"mesh must be a WorkerMesh, got {mesh!r}")
    if mesh.workers != M:
        raise ValueError(f"the mesh has {mesh.workers} workers, expected "
                         f"M={M}")
    mine = torch.device("cuda" if mesh.device is None else mesh.device)
    if device is not None:
        given = torch.device(device)
        same_index = (given.index is None or mine.index is None
                      or given.index == mine.index)
        if given.type != mine.type or not same_index:
            raise ValueError(f"device={device} differs from the mesh's "
                             f"device {mine}")
    if mesh.group is None:
        return None, mine
    return mesh, mine


def _algo_name(algo) -> str:
    return algo.name if isinstance(algo, DistAlgorithm) else str(algo)


@runtime_checkable
class TrainerBackend(Protocol):
    """One update iteration at a time, identically for every backend."""

    name: str
    kind: str  # "sim" or "prod" (numeric), "event" (wall-clock)

    def init(self, rng, params_single) -> Any: ...

    def step(self, state, batch, rng) -> Tuple[Any, Dict[str, Any]]: ...

    def summary(self) -> Dict[str, float]: ...


def _generator(rng, device: torch.device) -> torch.Generator:
    """A ``torch.Generator`` on ``device``: ``rng`` itself when it is one,
    else a new one seeded with ``rng`` (an int; ``None`` is 0)."""
    if isinstance(rng, torch.Generator):
        if rng.device.type != device.type:
            raise ValueError(f"generator on {rng.device}, state on {device}")
        return rng
    return torch.Generator(device=device).manual_seed(
        0 if rng is None else int(rng))


class SimTrainerBackend:
    """Numeric backend: the sim trainer, any registered algorithm.

    ``init(rng, params)`` also sets ``self.generator`` (a
    ``torch.Generator`` on ``device``: ``rng`` itself, or one seeded with
    the int ``rng``), which ``step`` draws from when its ``rng`` is None;
    ``drive`` hands it to every step."""

    kind = "sim"

    def __init__(self, algo, loss_fn: Callable, optimizer, schedule,
                 M: int, *, device=None, straggler_delays=None,
                 measure_drift: bool = True, fb_ratio: int = 1,
                 update_delay: int = 0):
        if isinstance(algo, str):
            algo = get_algorithm(algo)
        self.algo: DistAlgorithm = algo
        self.name = f"sim:{algo.name}"
        self.M = M
        self.device = resolve_device(device)
        self._box: Dict[str, Any] = {}
        self._init_fn, self._step_fn = make_sim_trainer(
            algo, loss_fn, optimizer, schedule, M,
            straggler_delays=straggler_delays, measure_drift=measure_drift,
            fb_ratio=fb_ratio, update_delay=update_delay,
            device=self.device, box=self._box)
        self.generator: Optional[torch.Generator] = None
        self._steps = 0
        self._last: Dict[str, Any] = {}

    @property
    def part(self):
        """The FlatPartition fixing the state's plane layout (after init)."""
        return self._box.get("part")

    def export_params(self, state):
        """Stacked ``(M, ...)`` parameter tree view of the state's plane."""
        if self.part is None:
            raise RuntimeError("call init() before export_params()")
        return self.part.unpack(state.params)

    def init(self, rng, params_single):
        self._steps = 0
        self.generator = _generator(rng, self.device)
        return self._init_fn(rng, params_single)

    def step(self, state, batch, rng=None):
        state, metrics = self._step_fn(
            state, batch, self.generator if rng is None else rng)
        self._steps += 1
        self._last = metrics
        return state, metrics

    def summary(self) -> Dict[str, float]:
        return _numeric_summary(self._steps, self._last)


class EventSimBackend:
    """Wall-clock backend: the event-driven simulator.

    ``init`` ignores the params (no numerics) and returns the simulator as
    the state; ``step`` ignores the batch and advances the event clock by
    one update iteration."""

    kind = "event"

    def __init__(self, algo, M: int, *, hw: Optional[HardwareModel] = None,
                 straggler_delays=None, sync_every: int = 8, seed: int = 0,
                 fb_ratio: int = 1, update_delay: int = 0):
        algo_name = _algo_name(algo)
        self.name = f"event:{algo_name}"
        self.M = M
        self._kw = dict(
            M=M, hw=hw or HardwareModel(), straggler_delays=straggler_delays,
            sync_every=sync_every, seed=seed, fb_ratio=fb_ratio,
            update_delay=update_delay)
        self._event_algo = _EVENT_ALIAS.get(algo_name, algo_name)
        self._sim: Optional[EventSimulator] = None
        # validate eagerly so misconfiguration fails at build, not step time
        EventSimulator(self._event_algo, **self._kw)

    def init(self, rng=None, params_single=None):
        self._sim = EventSimulator(self._event_algo, **self._kw)
        return self._sim

    def step(self, state: EventSimulator, batch=None, rng=None):
        return state, state.step()

    def result(self) -> SimResult:
        if self._sim is None:
            raise RuntimeError("call init() before result()")
        return self._sim.result()

    def summary(self) -> Dict[str, float]:
        r = self.result()
        return {"steps": float(r.iter_times.size),
                "total_time": r.total_time, "utilization": r.utilization,
                "mfu": r.mfu, "updates_per_s": r.updates_per_s,
                "fwd_passes_per_s": r.fwd_passes_per_s,
                "mean_grad_staleness": r.mean_grad_staleness}


class ProdTrainerBackend:
    """The decoupled LayUp lane with M workers stacked on one device, or
    spread over the ranks of a process group (``mesh=``).

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
    ``faults=None``.

    ``publisher`` (a :class:`repro_torch.serving.PlanePublisher`) gets the
    read plane after every step on the monolithic step and ``overlap=True``
    (a device copy, ``stable=False``: both lanes write the read plane in
    place later); ``streams > 1`` with a publisher raises ``ValueError``.

    ``tuning`` (a :class:`repro_torch.launch.tuner.TuningRecord` or the
    path of its JSON) replaces the hand-picked schedule: a record that
    loads sets ``overlap=True`` and fills ``fb_ratio``, ``update_delay`` and
    ``max_inflight_steps`` where the caller left their defaults (kwargs
    moved off their defaults win); one that fails to load warns and changes
    nothing.

    ``flat=False`` (the reference's legacy per-leaf state, which a record
    whose best grouping is ``"legacy"`` asks for, and which gives the
    reference's flat plane's numbers bit for bit) runs on the flat plane,
    the port's one state layout.

    ``mesh`` (a :class:`repro_torch.launch.mesh.WorkerMesh` of M workers
    with a ``torch.distributed`` group) spreads the workers over the
    group's ranks: each rank holds its ``L = M // world`` workers on the
    mesh's device, which wins over ``device`` (both given and different
    raises), and every rank runs the same program on the same sim-layout
    batches (and calls ``summary()`` alike: it sums counters over the
    ranks). The ring hop, the loss mean, the skip count and the drift
    cross ranks; the planes are the one-process step's bit for bit. Each
    rank draws the same shifts (checked at ``init``).
    ``summary()["wire_bytes_per_round"]`` is then the bytes this rank sent
    to other ranks per gossip round. Every option runs over such a mesh:
    the stream engine's threads each cross ranks on a process group of
    their own; the chaos controller is replicated on every rank (a donor
    on another rank sends its rows); a publisher publishes the rank's
    rows; a tuning record must resolve to the same schedule on every rank,
    or every rank raises ``RuntimeError``."""

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
        self.mesh, device = _check_mesh(mesh, M, device)
        # a tuning record (launch/tuner.py, DESIGN.md §16) replaces the
        # hand-picked schedule defaults; kwargs the caller moved off their
        # defaults always win, and a failed load warns and changes nothing
        self.tuning = None
        if tuning is not None:
            from repro_torch.launch.tuner import apply_tuning, resolve_tuning
            record = resolve_tuning(tuning)
            if record is not None:
                tuned = apply_tuning(record, fb_ratio=fb_ratio,
                                     update_delay=update_delay,
                                     max_inflight_steps=max_inflight_steps)
                fb_ratio = tuned["fb_ratio"]
                update_delay = tuned["update_delay"]
                max_inflight_steps = tuned["max_inflight_steps"]
                overlap = True
                self.tuning = record
        # the schedule the run takes (the record's, where one loaded)
        self.schedule = {"fb_ratio": int(fb_ratio),
                         "update_delay": int(update_delay),
                         "max_inflight_steps": max_inflight_steps,
                         "overlap": bool(overlap)}
        if tuning is not None and self.mesh is not None:
            # a record that loads on one rank and not on another would run
            # different schedules into a hang: every rank raises
            self.mesh.agree(self.schedule if self.tuning else None,
                            "tuning schedules")
        if int(streams) > 1 and not overlap:
            raise ValueError("streams > 1 is a property of the stage-graph "
                             "pipeline; it requires overlap=True")
        algo_name = _algo_name(algo)
        if not algo_name.startswith("layup"):
            raise ValueError(
                f"prod backend implements the layup family only, not "
                f"{algo_name!r} (the gossip ring is the algorithm)")
        self.name = f"prod:{algo_name}"
        self.M = M
        self.overlap = bool(overlap)
        self.wire = str(wire)
        self.streams = int(streams)
        self.compensate = float(compensate)
        self.update_delay = int(update_delay)
        self.publisher = publisher
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
                      membership=self.membership, publisher=publisher,
                      mesh=self.mesh)
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
                               compensate=self.compensate, mesh=self.mesh)

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

    def _check_shift_draws(self) -> None:
        """Every rank of a mesh must draw the same shifts: the first 16
        draws of a fresh generator go through the mesh's agreement."""
        draws = np.random.default_rng(0xC0FFEE).integers(
            0, len(self._shifts), 16)
        self.mesh.agree([list(self._shifts), draws.tolist()],
                        "gossip shifts")

    def init(self, rng, params_single):
        self._steps = 0
        self._shift_rng = np.random.default_rng(0xC0FFEE)
        if self.mesh is not None:
            self._check_shift_draws()
            self.mesh.reset_stats()
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

    def resume(self, step: int) -> None:
        """Continue at ``step`` a run whose state was restored from a
        checkpoint taken after ``step`` steps (``repro_torch.checkpoint``):
        the schedule, the FIFO's stamps and the host's gossip-shift draws
        go on where the saved run left off. Call it after ``init``. Over a
        mesh with a process group every rank replays the same draws, and the
        step and the next draw go through the mesh's agreement."""
        self._steps = 0
        self._shift_rng = np.random.default_rng(0xC0FFEE)
        for _ in range(int(step)):
            self._shift_rng.integers(0, len(self._shifts))
        self._steps = int(step)
        if self.mesh is not None:
            ahead = np.random.default_rng()
            ahead.bit_generator.state = self._shift_rng.bit_generator.state
            self.mesh.agree([int(step),
                             int(ahead.integers(0, len(self._shifts)))],
                            "resume steps and next shift draws")

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
        if self.mesh is not None:
            # what this rank sent to other ranks, per round of the run
            out["wire_bytes_per_round"] = (self.mesh.stats["bytes_sent"]
                                           / max(self._steps, 1))
            out["staging_s"] = self.mesh.stats["staging_s"]
        elif part is not None:
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
                 optimizer=None, schedule=None,
                 hw: Optional[HardwareModel] = None, **kw) -> TrainerBackend:
    """Single entry point over the three backends.

    kind="sim":   needs loss_fn, optimizer, schedule; any registered algo.
    kind="event": takes hw (default: the default HardwareModel).
    kind="prod":  needs loss_fn, optimizer, schedule; the layup family.
    Shared kwargs: straggler_delays, fb_ratio, update_delay; sim and prod
    also take device (default CUDA) and measure_drift, event takes
    sync_every and seed, prod the options of :class:`ProdTrainerBackend`.
    """
    if kind == "sim":
        if loss_fn is None or optimizer is None or schedule is None:
            raise ValueError("sim backend needs loss_fn, optimizer, schedule")
        return SimTrainerBackend(algo, loss_fn, optimizer, schedule, M, **kw)
    if kind == "event":
        return EventSimBackend(algo, M, hw=hw, **kw)
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
    backend's summary() entries}. The event backend takes batches of
    ``None``. The sim backend's steps draw from its ``generator`` (made by
    ``init`` from ``rng``: a ``torch.Generator`` or an int seed). Reading a
    history key copies that metric to the host after each step."""
    state = backend.init(rng, params_single)
    step_rng = getattr(backend, "generator", rng)
    hist: Dict[str, list] = {k: [] for k in history_keys}
    for batch in batches:
        state, metrics = backend.step(state, batch, step_rng)
        for k in history_keys:
            if k in metrics:
                hist[k].append(_host(metrics[k]))
    out: Dict[str, Any] = {"state": state,
                           "history": {k: np.asarray(v)
                                       for k, v in hist.items()}}
    out.update(backend.summary())
    return out
