"""Per-stage CUDA streams with one-sided signal gossip (port of
``repro/launch/streams.py``, DESIGN.md §13).

The single-stream :class:`~repro_torch.launch.pipeline.PipelineEngine`
enqueues every stage on one CUDA stream, so the card runs them one after
the other. This module runs the stages on **streams** of their own. A
:class:`Stream` is one host thread that owns a ``torch.cuda.Stream``: it
takes the stage tasks assigned to it in order, makes its CUDA stream wait
for each task's inputs, launches the stage there and records a CUDA event
after it. No stage blocks the host on the card: a stream thread waits only
until the producers of its inputs have been *launched* (their events
recorded); the card orders the work through ``Stream.wait_event``.

**One-sided signal gossip.** Stages coordinate through a
:class:`SignalBoard`: a producer pushes a buffer (one layer group's plane)
into a named slot as a new version, with the CUDA event recorded after it
on the producer's stream, and flips the slot's signal; a consumer waits
for ``signal >= v``, then makes its own stream wait on that event. Each
layer group's gossip mix launches as soon as ITS group's update is in,
instead of behind a barrier over the whole plane.

Stage-to-stream assignment (``streams=n``):

=========  =============================================================
n == 2     ``fwd`` (all R forward slices) | ``gossip`` (update + per-
           group mixes + clock/metrics)
n == 3     ``fwd`` | ``update`` | ``gossip``
n >= 4     ``fwd0..fwd{n-3}`` (slices round-robin) | ``update`` |
           ``gossip``
=========  =============================================================

**Buffers across streams.**

* The fused mix of the monolithic step writes the mixed plane into the live
  plane, which forward slices ``1..R-1`` of the same step may still be
  reading on the fwd stream. Here each group has an engine-owned ping-pong
  pair instead (the initial state's read and write planes): step ``t``'s
  plane is one buffer and its mix writes the other. Before the mix of step
  ``t`` writes that buffer, its stream waits for the forward tasks of step
  ``t − 1``, its last readers (on one fwd stream they precede step ``t``'s
  slice 0 anyway, so the overlap of step ``t``'s forwards with its gossip
  is kept).
* A tensor made on one stream and used on another is recorded as used
  there (``Tensor.record_stream``) as the consumer takes it, so the caching
  allocator does not hand its block out again while that stream may still
  read it; nothing is held longer than its last use.
* A payload that one consumer reads (slice 0's gradient plane, a group's
  update deltas) is taken off the board, so nothing holds it past its use;
  the plane slots keep two versions, the live one and the one a lagging
  forward slice may still ask for.
* A host mutation between steps (a chaos fault) first calls
  :meth:`StreamEngine.materialize`: every task launched, then the caller's
  stream waits for all of the engine's streams; the next step's tasks wait
  for the caller's stream. The ping-pong pair is kept, since the fault
  changes the live buffer in place. The alive mask (membership) rides into
  the update, per-group mix and clock stages; the chaos controller's
  liveness beats land on the board as ``live:{p}`` slots.
* The mixes and the clock of a step share the ``gossip`` stream, so the
  residual (int8 wire) is rewritten in place in order; the push-sum
  weights and the version clocks come out fresh.

**Timing.** Each task is bracketed by two timing events on its stream;
once they complete, their times are placed on the host clock through one
reference event and recorded in the
:class:`~repro_torch.launch.timeline.StageTimeline` as the task's
execution span, so spans of different streams overlap exactly when the
card ran two stages at once (``exec_overlap_s``). ``wait_s`` is the host
time the thread waited for its inputs' producers.

Lane spans (:func:`repro_torch.launch.timeline.span`, on under a profiler)
nest per thread: a forward task's ``fwd``, ``bwd`` and ``pack`` spans
have no parent and no step, the update task's ``update`` span and each
group's mix and the clock task (``gossip`` spans) carry their step, and
the host's ``step`` span holds the step's submission only.

On the CPU the same threads run the same coordination code; a stage's
work is done when it returns, so a span is host time around the stage.

Numerics are EXACT against the single-stream engine: the per-group mix is
the same lane closure on a one-group sub-dict, and the clock recomputes the
push-sum weight exchange with the same operations.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.launch.pipeline import cutout_args, record_fence
from repro_torch.launch.timeline import StageTimeline, _DeviceClock, in_span
from repro_torch.launch.train import alive_on_device

__all__ = [
    "SignalBoard", "Stream", "StreamTask", "TaskOutput", "StreamEngine",
    "resolve_refs",
]

# guard against a lost signal turning a fault into a silent hang: every wait
# in this module times out with a diagnostic instead
_WAIT_TIMEOUT_S = 600.0


class SignalBoard:
    """One-sided signal slots: ``put_signal`` / ``wait_until``.

    Each slot holds a monotonically increasing integer **signal** (a version
    clock) and, per signalled version, an optional **payload**.
    ``put_signal(slot, signal, payload)`` stores the payload and then flips
    the signal; a consumer that observes ``signal >= v`` also observes the
    payload pushed with ``v`` (the condition variable's lock orders them).
    Signals never go backwards: a stale put raises.

    ``wait_until(slot, v)`` waits for ``signal >= v`` but returns the
    payload pushed **with v**, not the latest, so a consumer of step ``t``
    that wakes after the producer signalled ``t+1`` still reads step ``t``'s
    buffer. Payloads are kept per version in a bounded window (``keep``
    versions); ``take`` reads a version and drops it, for a payload with one
    consumer."""

    def __init__(self, keep: int = 64):
        self._cv = threading.Condition()
        self._keep = int(keep)
        self._signals: Dict[str, int] = {}
        self._payloads: Dict[str, Dict[int, Any]] = {}
        self._poison: Optional[BaseException] = None

    def put_signal(self, slot: str, signal: int, payload: Any = None) -> None:
        """Push ``payload`` into ``slot`` as version ``signal`` and flip the
        slot's signal. Evicts versions older than the retention window."""
        signal = int(signal)
        with self._cv:
            cur = self._signals.get(slot)
            if cur is not None and signal < cur:
                raise ValueError(
                    f"signal for slot {slot!r} must be monotone: "
                    f"have {cur}, got {signal}")
            d = self._payloads.setdefault(slot, {})
            d[signal] = payload
            for v in [v for v in d if v <= signal - self._keep]:
                del d[v]
            self._signals[slot] = signal
            self._cv.notify_all()

    def wait_until(self, slot: str, value: int,
                   timeout: float = _WAIT_TIMEOUT_S) -> Any:
        """Block until ``slot``'s signal is ``>= value``; return the payload
        pushed with version ``value``. Raises ``TimeoutError`` after
        ``timeout`` seconds, ``KeyError`` if version ``value`` fell out of
        the retention window, ``RuntimeError`` once the board is
        poisoned."""
        return self._wait(slot, int(value), timeout, take=False)

    def take(self, slot: str, value: int,
             timeout: float = _WAIT_TIMEOUT_S) -> Any:
        """:meth:`wait_until`, then drop the payload of version ``value``:
        the board holds a buffer only until its one consumer has it."""
        return self._wait(slot, int(value), timeout, take=True)

    def _wait(self, slot: str, value: int, timeout: float, take: bool):
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._signals.get(slot, -(1 << 62)) < value:
                if self._poison is not None:
                    raise RuntimeError(
                        f"signal board poisoned while waiting on "
                        f"{slot!r} >= {value}") from self._poison
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cv.wait(remaining):
                    raise TimeoutError(
                        f"signal_wait_until({slot!r}, >= {value}) timed "
                        f"out at {self._signals.get(slot)!r}")
            if self._poison is not None:
                raise RuntimeError(
                    f"signal board poisoned while waiting on "
                    f"{slot!r} >= {value}") from self._poison
            d = self._payloads.get(slot, {})
            if value not in d:
                raise KeyError(
                    f"payload for {slot!r} version {value} evicted "
                    f"(retention window {self._keep}; have "
                    f"{sorted(d)[-4:]})")
            return d.pop(value) if take else d[value]

    def read(self, slot: str) -> Optional[int]:
        """Non-blocking probe of a slot's current signal (None if never
        signalled)."""
        with self._cv:
            return self._signals.get(slot)

    def poison(self, exc: BaseException) -> None:
        """Fail fast: wake every waiter and make all current and future
        waits raise (chained to ``exc``), so a task failure on one stream
        does not leave tasks on other streams waiting for signals that will
        never come."""
        with self._cv:
            if self._poison is None:
                self._poison = exc
            self._cv.notify_all()

    def reset(self) -> None:
        """Drop every slot and clear any poison (fresh run)."""
        with self._cv:
            self._signals.clear()
            self._payloads.clear()
            self._poison = None
            self._cv.notify_all()


# ---------------------------------------------------------------------------
# handing tensors from one stream to another
# ---------------------------------------------------------------------------


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def use_here(value, fence=None):
    """Make ``value`` safe to use on the calling thread's current CUDA
    stream: the stream waits for ``fence`` (the CUDA event after the work
    that made it), and each CUDA tensor of ``value`` is recorded as used on
    the stream, so the caching allocator keeps its block until the stream
    is done with it. A no-op for CPU tensors and a ``None`` fence."""
    cuda = [t for t in _tensors(value) if t.is_cuda]
    if fence is None and not cuda:
        return value
    stream = torch.cuda.current_stream()
    if fence is not None:
        stream.wait_event(fence)
    for t in cuda:
        t.record_stream(stream)
    return value


class StreamTask:
    """One unit of stream work: wait for the inputs, run a stage, signal.

    ``wait_fn()`` waits for the task's inputs and returns the argument tuple
    (its host time is the task's recorded wait); ``run_fn(*args)`` launches
    the stage on the stream; ``signals_fn(out, fence)`` (optional) pushes
    outputs onto the signal board with the task's fence and returns what
    the task keeps as its result. ``fence`` is the CUDA event after the
    stage on its stream (``None`` on the CPU): a consumer of the result
    makes its stream wait on it (:class:`TaskOutput`)."""

    def __init__(self, stage: str, step: int, *, slice_idx=None, group=None,
                 wait_fn: Optional[Callable[[], tuple]] = None,
                 run_fn: Callable = None,
                 signals_fn: Optional[Callable[[Any, Any], Any]] = None,
                 timeout: float = _WAIT_TIMEOUT_S):
        self.stage, self.step = stage, int(step)
        self.slice_idx, self.group = slice_idx, group
        self.wait_fn, self.run_fn = wait_fn, run_fn
        self.signals_fn = signals_fn
        self.timeout = float(timeout)
        self.enqueue: Optional[float] = None
        self.fence = None
        self._done = threading.Event()
        self._result: Any = None
        self._exc: Optional[BaseException] = None

    def result(self, timeout: Optional[float] = None) -> Any:
        """The stage's result once it has been launched (raises its
        exception if it failed). On the card the values may still be in
        flight: read them through :class:`TaskOutput`."""
        if not self._done.wait(self.timeout if timeout is None else timeout):
            raise TimeoutError(f"stream task {self.stage}@{self.step} "
                               f"was not launched within {self.timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result


class TaskOutput:
    """Lazy view into a task's (future) result.

    ``result()`` waits until the task has launched, makes the calling
    thread's current CUDA stream wait for it and returns the picked value,
    so it is safe to use there. ``float()`` and ``np.asarray()`` work, so
    metric dicts built from stream futures fit the ``TrainerBackend``
    contract; converting one waits only for its producing task."""

    __slots__ = ("_task", "_pick")

    def __init__(self, task: StreamTask, pick: Callable[[Any], Any] = None):
        self._task = task
        self._pick = pick if pick is not None else (lambda r: r)

    def result(self) -> Any:
        return use_here(self._pick(self._task.result()), self._task.fence)

    def __float__(self) -> float:
        return float(self.result())

    def __array__(self, dtype=None, copy=None):
        v = self.result()
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v, dtype=dtype)


def resolve_refs(tree: Any) -> Any:
    """Recursively replace :class:`TaskOutput` leaves in a (dict / tuple /
    list) tree with their results, each made safe to use on the current
    stream. Everything else passes through untouched."""
    if isinstance(tree, TaskOutput):
        return tree.result()
    if isinstance(tree, dict):
        return {k: resolve_refs(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(resolve_refs(v) for v in tree)
    return tree


class Stream:
    """One execution stream: a host thread that runs stage tasks FIFO on a
    ``torch.cuda.Stream`` of its own (on the CPU, in the thread), and calls
    ``on_done(task)`` after each (failed ones too).

    The bounded queue is the backpressure: ``submit`` blocks once the
    stream is ``maxsize`` tasks behind."""

    _SHUTDOWN = object()

    def __init__(self, name: str, timeline, *, device,
                 maxsize: int = 0,
                 clock: Callable[[], float] = time.perf_counter,
                 devclock: Optional[_DeviceClock] = None,
                 on_done: Optional[Callable[[StreamTask], None]] = None):
        self.name = name
        self.timeline = timeline
        self.device = torch.device(device)
        self.cuda = (torch.cuda.Stream(self.device)
                     if self.device.type == "cuda" else None)
        self._clock = clock
        self._devclock = devclock
        self.on_done = on_done
        self._lock = threading.Lock()
        self._spans: List[tuple] = []  # CUDA spans whose events may be open
        self._q: "queue.Queue" = queue.Queue(maxsize)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"stream:{name}")
        self._thread.start()

    def submit(self, task: StreamTask) -> StreamTask:
        task.enqueue = self._clock()
        self._q.put(task)  # blocks when the stream is maxsize tasks behind
        return task

    def _loop(self) -> None:
        if self.cuda is not None:
            torch.cuda.set_device(self.device)
        while True:
            task = self._q.get()
            if task is Stream._SHUTDOWN:
                return
            self._execute(task)
            del task  # its result lives on in its consumers only

    def _timing_event(self):
        if self.cuda is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _execute(self, task: StreamTask) -> None:
        t0 = self._clock()
        t_exec = t0
        start = end = None
        try:
            # grad mode and the current stream are per thread: set both
            with torch.no_grad(), torch.cuda.stream(self.cuda):
                args = task.wait_fn() if task.wait_fn is not None else ()
                t_exec = self._clock()
                start = self._timing_event()
                out = task.run_fn(*args)
                del args
                end = self._timing_event()
                task.fence = end
                if task.signals_fn is not None:
                    out = task.signals_fn(out, end)
            task._result = out
        except BaseException as e:  # surfaced at result()/wait time
            task._exc = e
            start = end = None
        t_done = self._clock()
        # the closures hold the step's inputs; drop them with the task run
        task.wait_fn = task.run_fn = task.signals_fn = None
        if self.timeline is not None:
            if end is None:
                self.timeline.record_exec(
                    task.stage, task.step, stream=self.name,
                    enqueue=task.enqueue, wait_s=t_exec - t0,
                    exec_start=t_exec, complete=t_done,
                    slice_idx=task.slice_idx, group=task.group)
            else:
                with self._lock:
                    self._spans.append((task.stage, task.step,
                                        task.slice_idx, task.group,
                                        task.enqueue, t_exec - t0, start,
                                        end))
        task._done.set()
        if self.on_done is not None:
            self.on_done(task)

    def flush_spans(self, block: bool) -> None:
        """Record in the timeline the CUDA spans whose events completed
        (all of them, waiting on the host, with ``block``)."""
        with self._lock:
            spans, self._spans = self._spans, []
        keep = []
        for span in spans:
            stage, step, r, group, enqueue, wait_s, start, end = span
            if block:
                end.synchronize()
            elif not end.query():
                keep.append(span)
                continue
            self.timeline.record_exec(
                stage, step, stream=self.name, enqueue=enqueue,
                wait_s=wait_s, exec_start=self._devclock.at(start),
                complete=self._devclock.at(end), slice_idx=r, group=group)
        with self._lock:
            self._spans = keep + self._spans

    def close(self) -> None:
        self._q.put(Stream._SHUTDOWN)
        self._thread.join(timeout=5.0)


class StreamEngine:
    """The pipeline engine's stage graph on per-stage execution streams.

    Same contract as :class:`~repro_torch.launch.pipeline.PipelineEngine`:
    ``step(state, batch, step_idx, shift_idx) -> (state, metrics)`` with
    the decoupled state layout; the gossip stage is split into one mix PER
    LAYER GROUP fed by push-and-signal:

    * ``fwd`` stream(s): each forward slice waits for its step's per-group
      plane signals and runs on the signalled buffers;
    * ``update`` (own stream at ``streams >= 3``): takes slice 0's
      gradient plane off the board, waits for the plane, runs the update,
      then pushes every group's update deltas (fused) or updated buffer
      with signal ``t``;
    * ``gossip`` stream: each group's mix waits for ITS group's update
      signal only, mixes, and pushes the mixed plane with signal ``t + 1``
      (what the next step's forwards wait for); the clock stage then
      recomputes the push-sum weight exchange, stamps the version clocks
      and folds the metrics.

    State leaves returned from ``step`` are :class:`TaskOutput` futures;
    pass them straight back into the next ``step``, or call
    :meth:`materialize` for tensors."""

    def __init__(self, *, R: int, D: int, M: int, group_names: Sequence[str],
                 stages: Dict[str, Any], group_stages: Dict[str, Any],
                 device, timeline: Optional[StageTimeline] = None,
                 n_streams: int = 2, fused: bool = False, describe: str = "",
                 max_inflight_steps: int = 3,
                 abstract_args=None, wire: str = "param",
                 compensate: float = 0.0,
                 wait_timeout_s: float = _WAIT_TIMEOUT_S):
        if n_streams < 2:
            raise ValueError(f"StreamEngine needs >= 2 streams, got "
                             f"{n_streams} (streams=1 is the single-stream "
                             f"PipelineEngine)")
        self.R, self.D, self.M = int(R), int(D), int(M)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # each stream thread selects the device by its index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.fused = bool(fused)
        self.wire = wire
        self.compensate = float(compensate)
        self.group_names = list(group_names)
        self._stages = stages              # {"fwd": [R], "update": fn}
        self._group_stages = group_stages  # {"mix": {g: fn}, "clock": fn}
        self.timeline = timeline if timeline is not None else StageTimeline()
        self.describe = describe
        self.abstract_args = abstract_args or {}
        self.max_inflight_steps = int(max_inflight_steps)
        self.wait_timeout_s = float(wait_timeout_s)
        # plane slots hold the live version and the one before it (a
        # lagging forward slice of the previous step); update deltas are
        # taken by their one consumer
        self.board = SignalBoard(keep=2)
        self._devclock = (_DeviceClock(self.timeline.clock)
                          if self.device.type == "cuda" else None)

        n = min(int(n_streams), self.R + 2)
        G = len(self.group_names)
        per_step_gossip = G + 2  # mixes + clock (+ the odd aux task)
        mk = lambda name, per_step: Stream(  # noqa: E731
            name, self.timeline, device=self.device,
            maxsize=max(4, self.max_inflight_steps * per_step),
            clock=self.timeline.clock, devclock=self._devclock,
            on_done=self._on_done)
        self._gossip = mk("gossip", per_step_gossip)
        if n >= 3:
            self._update = mk("update", 2)
            n_fwd = n - 2
        else:
            self._update = self._gossip
            n_fwd = 1
        if n_fwd == 1:
            self._fwd = [mk("fwd", self.R + 1)]
        else:
            self._fwd = [mk(f"fwd{i}", self.R // n_fwd + 2)
                         for i in range(n_fwd)]
        self._streams = [self._gossip] + (
            [self._update] if self._update is not self._gossip else []
        ) + self._fwd
        # tasks submitted and not yet run, and the first failure: counted,
        # not listed, so a finished task's result lives on only in its
        # consumers (a list of tasks would hold every step's gradient plane
        # while the host runs ahead)
        self._cv = threading.Condition()
        self._pending = 0
        self._failure: Optional[BaseException] = None
        self._pair: Optional[Dict[str, List[torch.Tensor]]] = None
        self._live = 0
        self._prev_fwd: List[StreamTask] = []
        self._masks: Dict[tuple, torch.Tensor] = {}  # device alive masks

    # -- helpers -----------------------------------------------------------

    def _on_done(self, task: StreamTask) -> None:
        if task._exc is not None:
            # tasks on OTHER streams waiting for signals wake and fail
            # instead of waiting out their timeout
            self.board.poison(task._exc)
        with self._cv:
            self._pending -= 1
            if task._exc is not None and self._failure is None:
                self._failure = task._exc
            self._cv.notify_all()

    @staticmethod
    def _plane_slot(g: str) -> str:
        return f"plane:{g}"

    @staticmethod
    def _upd_slot(g: str) -> str:
        return f"upd:{g}"

    def _task(self, stage: str, step: int, **kw) -> StreamTask:
        with self._cv:
            self._pending += 1
        return StreamTask(stage, step, timeout=self.wait_timeout_s, **kw)

    def _seed(self, state, t: int, host) -> None:
        """First step after (re-)init, or any state of tensors: push each
        group buffer of the read plane onto the board with signal ``t`` and
        make the ping-pong pair from the state's read and write planes (a
        second buffer is allocated where they are one).

        A materialized state whose read plane is the pair's live buffer (a
        host mutation between steps, e.g. a chaos fault, changes it in
        place) keeps the pair and the last forward tasks, which the next
        mix still waits for before it writes the other buffer."""
        read = state["read"]
        if isinstance(next(iter(read.values())), TaskOutput):
            return  # the plane already lives on the board
        for g in self.group_names:
            self.board.put_signal(self._plane_slot(g), t, (read[g], host))
        if self.fused and self._pair is not None and all(
                read[g] is self._pair[g][self._live]
                for g in self.group_names):
            return
        self._prev_fwd = []
        if self.fused:
            write = state["write"]
            self._pair = {g: [read[g], write[g] if write[g] is not read[g]
                              else torch.empty_like(read[g])]
                          for g in self.group_names}
            self._live = 0

    def _wait_plane(self, t: int) -> Dict[str, torch.Tensor]:
        return {g: use_here(*self.board.wait_until(
                    self._plane_slot(g), t, self.wait_timeout_s))
                for g in self.group_names}

    # -- the step ----------------------------------------------------------

    def step(self, state, batch, step_idx, shift_idx):
        board, timeout = self.board, self.wait_timeout_s
        t, sh = int(step_idx), int(shift_idx)
        gnames = self.group_names
        int8 = self.wire == "int8"
        for s in self._streams:
            s.flush_spans(block=False)
        if self._devclock is not None:
            self._devclock.start()
        mask = state.get("alive")  # membership: the host mask
        alive = alive_on_device(mask, self.device, self._masks)
        # the caller's work so far (the batch, a state of tensors, a copied
        # mask): every task of the step makes its stream wait for it
        host = record_fence(self.device)
        self._seed(state, t, host)

        def here(tree):
            return use_here(resolve_refs(tree), host)

        # forward slices: wait for the step's plane signals, run on the
        # signalled buffers (round-robin over the fwd streams). Slice 0
        # hands its gradient plane to the update through the board; each
        # task keeps only its losses.
        def fwd_signals(out, fence):
            if out[1] is not None:
                board.put_signal("grads", t, (out[1], fence))
            return out[0]

        fwd_tasks = []
        for r in range(self.R):
            task = self._task(
                "fwd", t, slice_idx=r,
                wait_fn=lambda: (self._wait_plane(t), here(batch)),
                run_fn=self._stages["fwd"][r], signals_fn=fwd_signals)
            self._fwd[r % len(self._fwd)].submit(task)
            fwd_tasks.append(task)
        losses = [TaskOutput(tk) for tk in fwd_tasks]
        prev_fwd, self._prev_fwd = self._prev_fwd, fwd_tasks

        # update: waits for slice 0's gradients and the plane; pushes each
        # group's deltas (fused) or updated buffer with signal t
        opt_ref, fifo_ref = state["opt"], state.get("fifo", ())
        theta_ref = state.get("theta")

        def upd_wait():
            grads = use_here(*board.take("grads", t, timeout))
            return (self._wait_plane(t), here(opt_ref), here(fifo_ref),
                    grads, here(theta_ref), t, here(alive))

        def upd_signals(out, fence):
            for g in gnames:
                board.put_signal(self._upd_slot(g), t, (out[0][g], fence))
            return out[1:]  # opt, fifo, staleness, skips[, θ']

        upd_task = self._task("update", t, wait_fn=upd_wait,
                              run_fn=self._stages["update"],
                              signals_fn=upd_signals)
        self._update.submit(upd_task)
        new_opt = TaskOutput(upd_task, lambda r: r[0])
        new_fifo = TaskOutput(upd_task, lambda r: r[1])
        upd_stale = TaskOutput(upd_task, lambda r: r[2])
        skips = TaskOutput(upd_task, lambda r: r[3])
        new_theta = TaskOutput(upd_task, lambda r: r[4])

        # per-group mixes: each waits for ITS group's update signal only,
        # then pushes the mixed plane with signal t+1. The fused mix writes
        # the other buffer of the group's pair, after step t−1's forward
        # slices (its last readers) are through.
        if self.fused:
            outs = {g: self._pair[g][1 - self._live] for g in gnames}
            self._live = 1 - self._live
        w_ref, versions_ref = state["w"], state["versions"]
        resid_ref = state.get("resid")
        mix_tasks: Dict[str, StreamTask] = {}
        for g in gnames:
            def mix_wait(g=g):
                for tk in prev_fwd:
                    tk.result()
                    use_here(None, tk.fence)
                lane_out = use_here(*board.take(self._upd_slot(g), t,
                                                timeout))
                x = (use_here(*board.wait_until(self._plane_slot(g), t,
                                                timeout))
                     if self.fused else None)
                resid = here(resid_ref[g]) if int8 else None
                out = use_here(outs[g]) if self.fused else None
                return (x, lane_out, resid, here(w_ref), sh, out,
                        here(alive))

            def mix_signals(out, fence, g=g):
                board.put_signal(self._plane_slot(g), t + 1, (out[0], fence))
                return out

            task = self._task("gossip", t, group=g, wait_fn=mix_wait,
                              run_fn=in_span(self._group_stages["mix"][g],
                                             "gossip", step=t),
                              signals_fn=mix_signals)
            self._gossip.submit(task)
            mix_tasks[g] = task
        mixed = {g: TaskOutput(tk, lambda r: r[0])
                 for g, tk in mix_tasks.items()}

        # clock/metrics: the push-sum weight exchange once more, the clock
        # stamp and the metric fold (the single-stream gossip stage's math)
        def clock_wait():
            return (here(w_ref), here(versions_ref),
                    tuple(lo.result() for lo in losses), upd_stale.result(),
                    skips.result(), t, sh, here(alive), mask)

        clock_task = self._task("clock", t, wait_fn=clock_wait,
                                run_fn=in_span(self._group_stages["clock"],
                                               "gossip", step=t))
        self._gossip.submit(clock_task)
        metric_keys = ["loss", "update_staleness", "weight_sum",
                       "nonfinite_skips", "layer_staleness",
                       "staleness_mean"] + (["peers_live"]
                                            if mask is not None else [])
        metrics = {k: TaskOutput(clock_task, (lambda r, k=k: r[2][k]))
                   for k in metric_keys}

        new_state = {"read": mixed, "write": mixed, "opt": new_opt,
                     "w": TaskOutput(clock_task, lambda r: r[0]),
                     "versions": TaskOutput(clock_task, lambda r: r[1])}
        if self.D > 0:
            new_state["fifo"] = new_fifo
        if int8:
            new_state["resid"] = {g: TaskOutput(tk, lambda r: r[1])
                                  for g, tk in mix_tasks.items()}
        if self.compensate > 0.0:
            new_state["theta"] = new_theta
        if mask is not None:
            new_state["alive"] = mask
        return new_state, metrics

    def submit_aux(self, stage: str, fn: Callable, arg_refs: tuple,
                   step: int) -> TaskOutput:
        """Run an auxiliary computation (the drift metric) on the gossip
        stream after the step's clock; its inputs may be
        :class:`TaskOutput` refs into the step just submitted."""
        task = self._task(stage, int(step),
                          wait_fn=lambda: resolve_refs(tuple(arg_refs)),
                          run_fn=fn)
        self._gossip.submit(task)
        return TaskOutput(task)

    # -- lifecycle ---------------------------------------------------------

    def materialize(self, tree):
        """Resolve every :class:`TaskOutput` leaf, safe to use, and to write
        in place, on the current stream: every task submitted so far has
        launched first, and the current stream then waits for all of the
        engine's streams (so for the tasks that only read the tensors too,
        such as the drift metric). The next step's tasks wait for the
        current stream in turn."""
        self._drain()
        out = resolve_refs(tree)
        if self.device.type == "cuda":
            cur = torch.cuda.current_stream(self.device)
            for s in self._streams:
                cur.wait_stream(s.cuda)
        return out

    def _drain(self) -> None:
        """Wait until every submitted task has launched (or failed)."""
        with self._cv:
            while self._pending:
                left = self._pending
                if not self._cv.wait_for(lambda: self._pending < left,
                                         timeout=self.wait_timeout_s):
                    raise TimeoutError(
                        f"{left} stream tasks made no progress in "
                        f"{self.wait_timeout_s}s")

    def finalize(self) -> None:
        """Wait until every submitted task has launched and its work on the
        card is done, record the spans, then re-raise the first failure.
        Every task is drained first, so no thread is left waiting when the
        exception surfaces."""
        self._drain()
        with self._cv:
            first, self._failure = self._failure, None
        for s in self._streams:
            s.flush_spans(block=True)
        if first is not None:
            raise first

    def reset(self) -> None:
        """Fresh measured run: drain the streams, clear the board, the
        ping-pong pair and the timeline."""
        self.finalize()
        self.board.reset()
        self.timeline.reset()
        self._pair, self._prev_fwd = None, []
        if self._devclock is not None:
            self._devclock.reset()

    def close(self) -> None:
        """Shut the stream threads down and drop the planes the engine holds
        (the board's payloads, the ping-pong pair). The threads are closed
        even when the drain raises: a poisoned pipeline must not leak
        them."""
        try:
            self.finalize()
        finally:
            for s in self._streams:
                s.close()
            self.board.reset()
            self._pair, self._prev_fwd = None, []

    def stage_cutouts(self) -> Dict[str, Tuple[Any, tuple]]:
        """Every stage paired with its abstract argument signature (the
        autotuner's extraction point, as ``PipelineEngine.stage_cutouts``).
        Keys: ``fwd0..fwdR-1``, ``update``, ``mix:{group}``, ``clock``."""
        args = cutout_args(self)
        out = {}
        for r, f in enumerate(self._stages["fwd"]):
            out[f"fwd{r}"] = (f, args["fwd"])
        out["update"] = (self._stages["update"], args["update"])
        for g in self.group_names:
            out[f"mix:{g}"] = (self._group_stages["mix"][g],
                               args[f"mix:{g}"])
        out["clock"] = (self._group_stages["clock"], args["clock"])
        return out
