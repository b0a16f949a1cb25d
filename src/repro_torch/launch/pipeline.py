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

``make_layup_decoupled_pipeline`` is the Model-level factory
(``make_step(overlap=True)``): the same engines over ``model.loss_fn``,
stepped with the global batch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import input_specs
from repro_torch.convert import to_torch
from repro_torch.core.layerview import FlatPartition, send_fractions
from repro_torch.core.pytree import tree_map
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import WorkerMesh
from repro_torch.launch.timeline import (StageTimeline, _block, _is_ready,
                                         in_span, span)
from repro_torch.launch.train import (_check_wire, _decoupled_metrics,
                                      _gossip_lanes, _local_fn,
                                      _mesh_workers, _ring_exchange,
                                      _ring_mesh, _spec, alive_on_device,
                                      backward_update_lane,
                                      combine_slice_losses,
                                      forward_slice_lane, gate_update,
                                      live_loss, make_decoupled_state,
                                      published_rows, rank_rows, stamp_live,
                                      straggler_active_fn, worker_batch)
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


# ---------------------------------------------------------------------------
# stage bodies: the monolithic step's lanes split at their boundaries
# ---------------------------------------------------------------------------


def _rows(tree: Dict[str, torch.Tensor], m: int) -> Dict[str, torch.Tensor]:
    return {k: v[m] for k, v in tree.items()}


def _stage_bodies(part: FlatPartition, R: int, M: int, device,
                  fwd_slices: Sequence[Callable], upd: Callable,
                  mix: Callable, shifts: Sequence[int], *,
                  active_fn: Optional[Callable] = None, fused: bool = False,
                  wire: str = "param", mesh: Optional[WorkerMesh] = None,
                  update_mesh: Optional[WorkerMesh] = None):
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
    frozen clocks and the live loss).

    ``mesh`` (a :class:`WorkerMesh` with a process group): the stages run
    on the rank's L workers, as the monolithic step does; the update stage
    sums the skips over the ranks (on ``update_mesh``, default ``mesh``)
    and the metrics gather the losses."""
    int8 = wire == "int8"
    update_mesh = mesh if update_mesh is None else update_mesh
    phi = torch.from_numpy(send_fractions(part.num_groups)).to(device)
    loc = _local_fn(mesh)
    row_elements = sum(part.group_sizes.values())

    def make_fwd_body(r):
        lane = fwd_slices[r]

        def fwd_body(read, batch):
            grads = ({k: torch.empty_like(v) for k, v in read.items()}
                     if r == 0 else None)
            losses = []
            for m in range(next(iter(read.values())).shape[0]):
                loss_m, g_m = lane(part.unpack(_rows(read, m)),
                                   _rows(batch, m), worker=m)
                if grads is not None:
                    with span("pack", worker=m, work=row_elements):
                        part.pack(g_m, out=_rows(grads, m))
                del g_m
                losses.append(loss_m)
            return losses, grads

        return fwd_body

    def update_body(write, opt_state, fifo, grads, theta, step_idx,
                    alive=None):
        with span("update", step=step_idx, work=write):
            active = (loc(active_fn(step_idx)) if active_fn is not None
                      else None)
            out = upd(write, opt_state, grads, fifo, step_idx, active=active,
                      theta=theta)
            if update_mesh is not None:
                out = out[:4] + (update_mesh.all_reduce_sum_(out[4]),) \
                    + tuple(out[5:])
            if alive is None:
                return out
            return (gate_update(out[0], None if fused else write,
                                loc(alive)),) + tuple(out[1:])

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
            _, w_keep, rw, _ = _ring_exchange(w, shift_idx, shifts, alive,
                                              mesh)
            w = w_keep + rw
        return w, stamp(versions, step_idx, alive)

    def metrics_fn(losses, w, versions, upd_stale, step_idx, skips,
                   alive=None, mask=None):
        per_worker = [combine_slice_losses(losses[0][m],
                                           [lr[m] for lr in losses[1:]], R)
                      for m in range(len(losses[0]))]
        return _decoupled_metrics(w, versions,
                                  live_loss(per_worker, alive, mesh),
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
        with span("gossip", step=step_idx, work=write):
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
    its state. ``split_batch``, where given, turns the caller's batch into
    the engine's worker layout first (the Model path: the global batch);
    ``chaos`` is set by ``make_step(faults=)``."""
    engine: Any
    init_state: Callable
    describe: str = ""
    split_batch: Optional[Callable] = None
    chaos: Any = None

    def fn(self, state, batch, step_idx, shift_idx):
        with span("step", step=int(step_idx)):
            if self.split_batch is not None:
                batch = self.split_batch(batch)
            return self.engine.step(state, batch, step_idx, shift_idx)

    @property
    def timeline(self) -> StageTimeline:
        return self.engine.timeline


# ---------------------------------------------------------------------------
# abstract signatures and the factory
# ---------------------------------------------------------------------------


def flat_abstract_args(part: FlatPartition, optimizer: Optimizer, M: int,
                       R: int, D: int, *, batch_abs=None,
                       fused: bool = False, wire: str = "param",
                       compensate: float = 0.0,
                       groups: bool = False,
                       local_workers: Optional[int] = None
                       ) -> Dict[str, tuple]:
    """The argument signature of every stage, keyed like the engines'
    ``abstract_args`` (``"fwd"``/``"update"``/``"gossip"``, plus
    ``"mix:{group}"``/``"clock"`` with ``groups=True``, the stream
    engine's). Each tensor is a ``(shape, dtype)`` pair, a host integer
    the type ``int``, an absent argument ``None``. Optimizer shapes come
    from running it on meta tensors (nothing is allocated).
    ``batch_abs=None`` leaves a placeholder the backend fills from the
    first batch it sees. ``local_workers`` (a rank's L on a mesh with a
    process group) sizes the per-worker rows; the weights and clocks stay
    over all M."""
    L = M if local_workers is None else int(local_workers)
    meta = part.abstract_plane((L,))
    plane = tree_map(_spec, meta)
    opt_meta = optimizer.init(meta)
    opt = tree_map(_spec, opt_meta)
    f32 = ((), torch.float32)
    w_abs = ((M,), torch.float32)
    v_abs = ((M, part.num_groups), torch.float32)
    losses_abs = tuple(tuple(f32 for _ in range(L)) for _ in range(R))
    fifo = ()
    if D > 0:
        fifo = {"g": {g: ((L, D, n), part.group_dtypes[g])
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


def _check_engine_options(*, streams: int, publisher, wire: str,
                          compensate: float) -> None:
    """The reference's rules: the stream engine takes no publisher, and
    the wire and compensation knobs are checked."""
    if streams > 1 and publisher is not None:
        raise ValueError("publisher is not supported with streams > 1: "
                         "the stream engine's read plane is a future, not "
                         "a stable handle to publish (serve from a "
                         "streams=1 engine, or materialize snapshots)")
    _check_wire(wire, compensate)


def _engine_tags(use_pallas: bool, wire: str, compensate: float) -> str:
    return (f"{', pallas' if use_pallas else ''}"
            f"{', wire=int8' if wire == 'int8' else ''}"
            f"{f', comp={float(compensate):g}' if compensate else ''}")


def _build_engine(part: FlatPartition, loss_fn: Callable,
                  optimizer: Optimizer, schedule: Callable, *, M: int,
                  R: int, D: int, shifts: Sequence[int], device,
                  use_pallas: bool, streams: int, wire: str,
                  compensate: float, describe: str, abstract_args,
                  active_fn: Optional[Callable] = None,
                  timeline: Optional[StageTimeline] = None,
                  max_inflight_steps: Optional[int] = None,
                  wait_timeout_s: float = 600.0,
                  mesh: Optional[WorkerMesh] = None):
    """The engine over the decoupled lanes of ``loss_fn``: a
    :class:`PipelineEngine`, or with ``streams > 1`` a
    :class:`repro_torch.launch.streams.StreamEngine` (its gossip stage split
    per layer group). The engine's ``aux_mesh`` is the mesh that work
    submitted after a step crosses ranks on (the drift).

    Over a ``mesh`` with a process group the stream engine's update thread
    (the skip count) and gossip thread (the per-group hops, the loss
    gather, the drift) each cross ranks on a process group of their own
    (:meth:`WorkerMesh.role_meshes`, made here on every rank in the same
    order); the forward threads cross none. One thread issues a role's
    operations in its FIFO order, the same on every rank: the per-group
    mixes in the plane's group order, whatever order the groups' updates
    come in."""
    hop_mesh = upd_mesh = mesh
    if mesh is not None and streams > 1:
        roles = mesh.role_meshes(("update", "gossip"))
        hop_mesh, upd_mesh = roles["gossip"], roles["update"]
    fwd_slices = [forward_slice_lane(loss_fn, fb_ratio=R, slice_idx=r)
                  for r in range(R)]
    upd = backward_update_lane(optimizer, schedule, update_delay=D,
                               apply=not use_pallas, compensate=compensate)
    mix, fused = _gossip_lanes(part, M, shifts, use_pallas=use_pallas,
                               wire=wire, mesh=hop_mesh)
    bodies = _stage_bodies(part, R, M, device, fwd_slices, upd,
                           mix if fused is None else fused, shifts,
                           active_fn=active_fn, fused=use_pallas, wire=wire,
                           mesh=hop_mesh, update_mesh=upd_mesh)
    common = dict(R=R, D=D, M=M, stages=_make_stages(bodies), device=device,
                  timeline=timeline, fused=use_pallas, wire=wire,
                  compensate=compensate, abstract_args=abstract_args,
                  describe=describe)
    if max_inflight_steps is not None:
        common["max_inflight_steps"] = int(max_inflight_steps)
    if streams > 1:
        from repro_torch.launch.streams import StreamEngine
        engine = StreamEngine(
            group_names=list(part.group_sizes),
            group_stages=_make_group_stages(bodies, part.group_sizes),
            n_streams=streams, wait_timeout_s=wait_timeout_s, **common)
    else:
        engine = PipelineEngine(**common)
    engine.aux_mesh = hop_mesh
    return engine


def make_layup_decoupled_pipeline(model, mesh, optimizer: Optimizer,
                                  schedule: Callable, shape,
                                  shifts: Sequence[int] = (1, 2, 4, 8),
                                  fb_ratio: int = 2, update_delay: int = 1,
                                  timeline: Optional[StageTimeline] = None,
                                  use_pallas: bool = False,
                                  streams: int = 1, wire: str = "param",
                                  compensate: float = 0.0,
                                  membership: bool = False,
                                  max_inflight_steps: Optional[int] = None,
                                  wait_timeout_s: float = 600.0
                                  ) -> PipelineStep:
    """The decoupled LayUp step of ``model`` as a stage-graph engine (the
    Model path of ``make_step(overlap=True)``): the stages of
    :func:`make_pipeline_backend_trainer` over ``model.loss_fn`` on the
    mesh's M workers, stepped with the global batch (``PipelineStep.fn``
    splits it over the workers). ``streams > 1`` runs the stream engine.
    The engine's abstract arguments (the tuner's cutouts) are the plane's,
    with the batch's worker layout from ``input_specs``. On a mesh with a
    process group the stages run on the rank's L workers (``init_state``
    takes all M stacked params and keeps the rank's rows)."""
    M, device = _mesh_workers(mesh)
    ring = _ring_mesh(mesh, M)
    L = M if ring is None else ring.local_workers
    R, D = int(fb_ratio), int(update_delay)
    if shape.global_batch % (M * max(R, 1)):
        raise ValueError(
            f"global_batch={shape.global_batch} must divide by "
            f"M*R={M}*{R} for the decoupled forward lane")
    shifts = tuple(s % M for s in shifts if s % M != 0) or (1,)
    _check_engine_options(streams=streams, publisher=None, wire=wire,
                          compensate=compensate)
    part = FlatPartition(model.abstract_params())
    batch_meta = {k: torch.empty(s, dtype=dt, device="meta")
                  for k, (s, dt) in input_specs(model.cfg, shape).items()}
    abstract_args = flat_abstract_args(
        part, optimizer, M, R, D,
        batch_abs=tree_map(_spec, rank_rows(worker_batch(batch_meta, M),
                                            ring)),
        fused=use_pallas, wire=wire, compensate=compensate,
        groups=streams > 1, local_workers=L)
    tags = _engine_tags(use_pallas, wire, compensate)
    describe = (f"layup decoupled stream pipeline (M={M}, R={R}, D={D}, "
                f"shifts={shifts}, streams={streams}, "
                f"groups={len(part.group_sizes)}{tags})" if streams > 1 else
                f"layup decoupled pipeline (M={M}, R={R}, D={D}, "
                f"shifts={shifts}, stages={R + 2}{tags})")
    engine = _build_engine(
        part, model.loss_fn, optimizer, schedule, M=M, R=R, D=D,
        shifts=shifts, device=device, use_pallas=use_pallas,
        streams=streams, wire=wire, compensate=compensate, describe=describe,
        abstract_args=abstract_args, timeline=timeline,
        max_inflight_steps=max_inflight_steps, wait_timeout_s=wait_timeout_s,
        mesh=ring)

    def init_state(params_stacked):
        return make_decoupled_state(
            to_torch(rank_rows(params_stacked, ring), device), optimizer,
            update_delay=D, part=part, wire=wire, compensate=compensate,
            membership=membership, mesh=ring)

    return PipelineStep(engine, init_state, engine.describe,
                        split_batch=lambda b: rank_rows(worker_batch(
                            to_torch(b, device), M), ring))


def make_pipeline_backend_trainer(loss_fn: Callable, optimizer: Optimizer,
                                  schedule: Callable, M: int, *,
                                  device=None,
                                  shifts: Sequence[int] = (1, 2, 4, 8),
                                  fb_ratio: int = 1, update_delay: int = 0,
                                  straggler_delays=None,
                                  measure_drift: bool = False,
                                  timeline: Optional[StageTimeline] = None,
                                  use_pallas: bool = False,
                                  publisher=None,
                                  streams: int = 1, wire: str = "param",
                                  compensate: float = 0.0,
                                  membership: bool = False,
                                  max_inflight_steps: Optional[int] = None,
                                  wait_timeout_s: float = 600.0,
                                  mesh: Optional[WorkerMesh] = None):
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

    ``mesh`` (a :class:`WorkerMesh` with a process group) runs the stages
    on the rank's L workers on the mesh's device, as the monolithic trainer
    does; the stream engine's threads cross ranks on groups of their own
    (:func:`_build_engine`).

    Returns ``(init_fn, step_fn, shifts, box)``: ``box["engine"]`` holds
    the engine and ``box["part"]`` the FlatPartition once ``init_fn`` has
    seen the params."""
    _check_engine_options(streams=streams, publisher=publisher, wire=wire,
                          compensate=compensate)
    ring = _ring_mesh(mesh, M)
    device = resolve_device(device) if ring is None else \
        ring.resolved_device()
    L = M if ring is None else ring.local_workers
    R, D = int(fb_ratio), int(update_delay)
    shifts = tuple(s % M for s in shifts if s % M != 0) or (1,)
    active_fn = straggler_active_fn(M, straggler_delays, device)
    tags = _engine_tags(use_pallas, wire, compensate)
    box: Dict[str, Any] = {}

    def build(params_single):
        part = FlatPartition(params_single)

        def absargs():
            return flat_abstract_args(part, optimizer, M, R, D,
                                      batch_abs=box.get("batch_abs"),
                                      fused=use_pallas, wire=wire,
                                      compensate=compensate,
                                      groups=streams > 1, local_workers=L)
        describe = (f"stream pipeline backend (M={M}, R={R}, D={D}, "
                    f"streams={streams}, "
                    f"groups={len(part.group_sizes)}{tags})" if streams > 1
                    else f"pipeline backend (M={M}, R={R}, D={D}, "
                    f"flat=True{tags})")
        engine = _build_engine(
            part, loss_fn, optimizer, schedule, M=M, R=R, D=D, shifts=shifts,
            device=device, use_pallas=use_pallas, streams=streams,
            wire=wire, compensate=compensate, describe=describe,
            abstract_args=absargs, active_fn=active_fn,
            timeline=timeline, max_inflight_steps=max_inflight_steps,
            wait_timeout_s=wait_timeout_s, mesh=ring)
        return engine, part

    def init_fn(rng, params_single):
        del rng
        params_single = to_torch(params_single, device)
        stacked = tree_map(lambda p: p[None].expand((L,) + tuple(p.shape)),
                           params_single)
        if "engine" not in box:
            box["engine"], box["part"] = build(params_single)
            # the plane's elements, the drift span's work
            box["elements"] = L * sum(box["part"].group_sizes.values())
        return make_decoupled_state(stacked, optimizer, update_delay=D,
                                    part=box["part"], wire=wire,
                                    compensate=compensate,
                                    membership=membership, mesh=ring)

    def step_fn(state, batch, step_idx, shift_idx):
        if "engine" not in box:
            raise RuntimeError("call init_fn before step_fn")
        with span("step", step=int(step_idx)):
            return engine_step(box["engine"], state, batch, int(step_idx),
                               shift_idx)

    def engine_step(eng, state, batch, step_idx, shift_idx):
        batch = rank_rows(to_torch(batch, device), ring)
        if "batch_abs" not in box:
            # the forward batch signature, learnt from the first batch
            box["batch_abs"] = tree_map(_spec, batch)
            if isinstance(eng.abstract_args, dict) and eng.abstract_args:
                eng.abstract_args["fwd"] = (eng.abstract_args["fwd"][0],
                                            box["batch_abs"])
        state, metrics = eng.step(state, batch, step_idx, shift_idx)
        if measure_drift:
            from repro_torch.core.api import disagreement
            drift = in_span(torch.no_grad()(lambda read, w: disagreement(
                read, w, mesh=eng.aux_mesh)), "drift", step=step_idx,
                work=box["elements"])
            if streams > 1:
                # on the gossip stream after the step's clock
                metrics["disagreement"] = eng.submit_aux(
                    "drift", drift, (state["read"], state["w"]), step_idx)
            else:
                metrics["disagreement"] = drift(state["read"], state["w"])
        if publisher is not None:
            publisher.publish(state["read"], state["versions"], state["w"],
                              step_idx,
                              drift=metrics.get("disagreement"),
                              stable=False, rows=published_rows(ring))
        return state, metrics

    return init_fn, step_fn, shifts, box
