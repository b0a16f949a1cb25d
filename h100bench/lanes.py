"""The port's lane spans of a ``--trace 1`` run, read once per
:class:`h100bench.trace.Trace`.

The program records a span around each lane of its decoupled step while a
``torch.profiler`` session is active (``repro_torch.launch.timeline``:
``step``, ``fwd``, ``bwd``, ``pack``, ``update``, ``gossip``, ``drift``),
with host times on the profiler's clock and each span's device time
between two CUDA events. The first reader of a trace takes the spans from
the program's record (which clears it) and keeps those inside the
profiled window, from the trace's first event to its last; a program
without the record gives none, and every reader then returns ``None``.

Besides the metrics' readers, :func:`work_per_step` and
:func:`passes_at_peak` read the spans' ``work`` counts (tokens, plane
elements) for ``tools/lane_split.py``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from h100bench.counts.peaks import HBM_BYTES_PER_S

MS = 1e6  # ns


def _program_spans() -> List[dict]:
    try:
        from repro_torch.launch.timeline import lane_spans
    except ImportError:  # a program without lane spans
        return []
    return lane_spans()


def spans(trace) -> List[dict]:
    """The spans of ``trace``'s profiled window, read from the program on
    the first call and kept on the trace."""
    got = trace.__dict__.get("lane_spans")
    if got is None:
        events = trace.kernels + trace.host_ops
        got = []
        if events:
            first = min(s for _, s, _ in events)
            last = max(s + d for _, s, d in events)
            got = [sp for sp in _program_spans()
                   if first <= sp["start_ns"] and sp["end_ns"] <= last]
        trace.lane_spans = got
    return got


def device_ms_per_step(trace, name: str) -> Optional[float]:
    """The device milliseconds of every ``name`` span, per profiled step;
    ``None`` without such spans or without their device times."""
    ms = [sp["device_ms"] for sp in spans(trace) if sp["name"] == name]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / trace.steps


def work_per_step(trace, name: str) -> Optional[float]:
    """The ``work`` of every ``name`` span (tokens, or plane elements), per
    profiled step; ``None`` without such spans or without their counts."""
    work = [sp["work"] for sp in spans(trace) if sp["name"] == name]
    if not work or any(w is None for w in work):
        return None
    return sum(work) / trace.steps


def passes_at_peak(trace, name: str, element_bytes: int) -> Optional[float]:
    """The device time of the ``name`` spans over the time one pass over
    their work (plane elements of ``element_bytes`` each, read or written
    once) takes at HBM's peak: how many such passes the lane's time would
    hold. A lane that reads and writes each element of a few planes once
    needs a handful; ``None`` without spans, device times or counts."""
    ms = device_ms_per_step(trace, name)
    work = work_per_step(trace, name)
    if ms is None or not work:
        return None
    return ms / 1e3 / (work * element_bytes / HBM_BYTES_PER_S)


def _union(intervals: Sequence[Tuple[int, int]]) -> List[List[int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _covered(intervals: Sequence[Sequence[int]], a: int, b: int) -> int:
    """Nanoseconds of ``[a, b]`` that the disjoint ``intervals`` cover."""
    return sum(max(0, min(b, e) - max(a, s)) for s, e in intervals)


def _steps(trace) -> List[Tuple[int, int]]:
    """The outermost ``step`` spans (an engine's ``step`` inside another's
    would count its time twice)."""
    return [(sp["start_ns"], sp["end_ns"]) for sp in spans(trace)
            if sp["name"] == "step" and sp.get("parent") is None]


def host_dispatch_ms_per_step(trace) -> Optional[float]:
    """Host milliseconds inside ``step`` spans outside the trace's CUDA
    runtime calls (``host_ops``, merged over threads), per profiled step:
    the Python and ATen time a step needs."""
    steps = _steps(trace)
    if not steps:
        return None
    calls = _union([(s, s + d) for _, s, d in trace.host_ops])
    ns = sum((b - a) - _covered(calls, a, b) for a, b in steps)
    return ns / MS / trace.steps


def dispatch_idle_ms_per_step(trace) -> Optional[float]:
    """Milliseconds of the trace's device idle gaps that fall inside
    ``step`` spans (the card idle while the host was in the step), per
    profiled step."""
    steps = _steps(trace)
    if not steps:
        return None
    ns = sum(_covered(trace.gaps, a, b) for a, b in steps)
    return ns / MS / trace.steps
