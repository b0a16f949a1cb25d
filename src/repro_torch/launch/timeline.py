"""The port's one timing record: the stage timeline of the pipeline and
stream engines (DESIGN.md §10, §13) and the lane spans of the decoupled
step.

:class:`StageTimeline` keeps three kinds of events: the pipeline engine's
dispatch events, the stream engine's execution events, and lane spans.

**Lane spans** (:func:`span`) mark the lanes inside every decoupled step
(``launch/train.py``, ``launch/pipeline.py``, ``launch/streams.py``):

=========  ==============================================  ==============
name       around                                          ``work``
=========  ==============================================  ==============
``step``   one step of the decoupled step (all below)      --
``fwd``    ``loss_fn`` of one forward slice of one worker  tokens
``bwd``    ``torch.autograd.grad`` of slice 0 (with the    tokens
           recompute of the checkpointed blocks)
``pack``   one worker's gradients packed into the plane    plane elements
``update`` the update lane (FIFO, verdicts, optimizer)     plane elements
``gossip`` the mix, the push-sum weights and the clock     plane elements
           stamp
``drift``  the disagreement diagnostic                     plane elements
=========  ==============================================  ==============

A span records its name, its host start and end, its id and its parent's
(the innermost span open on the same thread), the step, the worker and
the forward slice where they apply (a span given no step takes its
parent's), and its work count, counted as the span opens (:func:`_count`:
a batch's tokens, a plane's elements). On a CUDA device it also records a
pair of timing ``torch.cuda.Event`` objects on the current stream; the
span's ``device_ms`` is read when the record is read, never during the
step. ``tools/lane_split.py`` reads them all: it places each kernel in a
lane down the parent links from its ``step`` span, and sets each lane's
device time against its work (microseconds a token; for a plane lane,
the passes over the plane that HBM's peak would move in that time).

Spans are on only while a ``torch.profiler`` session is active in the
process (the convention of ``torch.autograd.profiler.record_function``).
When off, :func:`span` checks one flag and hands back a shared no-op
context: no clock read, no event, no allocation. Host times are
nanoseconds on the base of the profiler's event timestamps (the system's
real-time clock): ``time.perf_counter_ns()`` readings placed by one
(``perf_counter_ns``, ``time_ns``) pair taken at the first span after the
record was last read or cleared. Spans go into one process-wide record,
:data:`LANES`, kept in memory up to :data:`SPAN_CAP` spans (the oldest
dropped first), and are read and cleared through :func:`lane_spans`.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

# spans kept in memory; past it the oldest are dropped
SPAN_CAP = 100_000

# the host clocks a span reads (module attributes, so tests can replace
# them)
_perf_ns = time.perf_counter_ns
_real_ns = time.time_ns

_OFF = contextlib.nullcontext()
_local = threading.local()  # per thread: the stack of open spans

if hasattr(torch.autograd.profiler, "_is_profiler_enabled"):
    def spans_on() -> bool:
        """Whether a ``torch.profiler`` session is active in the process."""
        return torch.autograd.profiler._is_profiler_enabled
else:  # a torch without the process-wide flag: the profiler's own check
    spans_on = torch._C._autograd._profiler_enabled


# ---------------------------------------------------------------------------
# fences
# ---------------------------------------------------------------------------


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
# stage timeline: measured dispatch/complete timestamps, overlap accounting
# and lane spans
# ---------------------------------------------------------------------------


class StageTimeline:
    """Host-side record of every stage dispatch, stage execution and lane
    span.

    Two kinds of events share ``events``:

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
      inputs' producers before it launched.

    The third kind, **lane spans** (:func:`span`, into :data:`LANES`), is
    kept apart from them, in at most :data:`SPAN_CAP` closed spans read by
    :meth:`take_spans`; :meth:`summary` does not read them."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []
        self._pending: List[Tuple[Dict[str, Any], Any]] = []
        self._spans: "collections.deque[_Span]" = collections.deque(
            maxlen=SPAN_CAP)
        self._span_ids = itertools.count()
        self._anchor: Optional[Tuple[int, int]] = None

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
            self._spans.clear()
            self._anchor = None

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
        """Write the events (times relative to the first dispatch), the lane
        spans (:meth:`take_spans` without clearing: nanoseconds on the
        profiler's clock) and the summary as JSON."""
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
            json.dump({"summary": s, "events": events,
                       "spans": self.take_spans(clear=False)}, f, indent=1)
        return path

    # -- lane spans ----------------------------------------------------------

    def _open_span(self, sp: "_Span") -> None:
        """Number a span as it opens and give it the anchor that places its
        times on the profiler's clock: the first span after a read or a
        clear takes a fresh one."""
        sp.id = next(self._span_ids)
        if self._anchor is None:
            with self._lock:
                if self._anchor is None:
                    self._anchor = (_perf_ns(), _real_ns())
        sp.anchor = self._anchor

    def _close_span(self, sp: "_Span") -> None:
        with self._lock:
            self._spans.append(sp)

    def take_spans(self, clear: bool = True) -> List[Dict[str, Any]]:
        """The closed lane spans, oldest first, as dicts ``{name, id,
        parent, step, worker, slice, work, start_ns, end_ns,
        device_ms}``: host times in nanoseconds on the profiler's clock,
        ``device_ms`` the time between the span's two CUDA events (waited
        for here; ``None`` off CUDA). ``clear`` empties the record and drops
        the clock anchor, so the next span takes a fresh one."""
        with self._lock:
            spans = list(self._spans)
            if clear:
                self._spans.clear()
                self._anchor = None
        out = []
        for sp in spans:
            perf0, real0 = sp.anchor
            ms = None
            if sp.events is not None:
                start, end = sp.events
                end.synchronize()
                ms = start.elapsed_time(end)
            out.append({"name": sp.name, "id": sp.id, "parent": sp.parent,
                        "step": sp.step, "worker": sp.worker,
                        "slice": sp.slice, "work": sp.work,
                        "start_ns": real0 + sp.t0 - perf0,
                        "end_ns": real0 + sp.t1 - perf0, "device_ms": ms})
        return out


# the process-wide record of lane spans
LANES = StageTimeline()


def _count(work) -> Optional[int]:
    """A span's work count: an ``int`` as given; a tensor's elements; a
    batch's tokens (the elements of its ``labels``); a plane's elements
    (summed over its groups)."""
    if work is None or isinstance(work, int):
        return work
    if isinstance(work, torch.Tensor):
        return work.numel()
    if "labels" in work:
        return work["labels"].numel()
    return sum(v.numel() for v in work.values())


class _Span:
    """One open lane span (see :func:`span`)."""

    __slots__ = ("name", "step", "worker", "slice", "work", "id", "parent",
                 "anchor", "t0", "t1", "events")

    def __init__(self, name, step, worker, slice_idx, work):
        self.name, self.step, self.worker = name, step, worker
        self.slice, self.work = slice_idx, _count(work)

    def __enter__(self) -> "_Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.parent = None if parent is None else parent.id
        if self.step is None and parent is not None:
            self.step = parent.step
        LANES._open_span(self)
        stack.append(self)
        self.events = None
        self.t0 = _perf_ns()
        if torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.events = (start, None)
        return self

    def __exit__(self, *exc) -> None:
        if self.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.events = (self.events[0], end)
        self.t1 = _perf_ns()
        _local.stack.pop()
        LANES._close_span(self)


def span(name: str, *, step: Optional[int] = None, worker=None,
         slice: Optional[int] = None, work=None):
    """A context manager that records a lane span of ``name`` into
    :data:`LANES` while a ``torch.profiler`` session is active, else does
    nothing (one check; see the module's docstring). ``step`` (default:
    the parent span's), ``worker`` and ``slice`` place it in the step;
    ``work`` is what its counter counts (:func:`_count`: a count, a batch
    or a plane), counted only when the span records."""
    if not spans_on():
        return _OFF
    return _Span(name, step, worker, slice, work)


def in_span(fn: Callable, name: str, **kw) -> Callable:
    """``fn`` run inside ``span(name, **kw)`` (for a task that another
    thread runs)."""
    def run(*args, **kwargs):
        with span(name, **kw):
            return fn(*args, **kwargs)
    return run


def lane_spans(clear: bool = True) -> List[Dict[str, Any]]:
    """The accessor of the process-wide lane spans: every closed span since
    the last read or clear, as :meth:`StageTimeline.take_spans` gives them;
    ``clear`` (the default) empties the record."""
    return LANES.take_spans(clear=clear)


# ---------------------------------------------------------------------------
# device clock
# ---------------------------------------------------------------------------


class _DeviceClock:
    """Places CUDA event times on the host clock: one reference event, whose
    completion the host observes right away, anchors the others."""

    def __init__(self, clock: Callable[[], float]):
        self._clock = clock
        self._ref = None
        self._t_ref = 0.0

    def start(self) -> None:
        if self._ref is None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ev.synchronize()
            self._t_ref = self._clock()
            self._ref = ev

    def at(self, ev) -> float:
        return self._t_ref + self._ref.elapsed_time(ev) / 1e3

    def reset(self) -> None:
        self._ref = None
