"""The six lane-span readers (``h100bench.lanes``) on made-up spans and a
made-up trace, against values worked by hand; each returns None with no
spans, with spans outside the profiled window, and with a program that
has no span record. The readers of the spans' work counts, likewise."""
import sys

import pytest

from h100bench import lanes, metrics
from h100bench.trace import Trace

MS = 1_000_000  # ns
LANE_METRICS = ["fwd_ms_per_step", "bwd_ms_per_step", "update_ms_per_step",
                "gossip_ms_per_step", "host_dispatch_ms_per_step",
                "dispatch_idle_ms_per_step"]

# device busy 0–10, 12–20, 25–40 ms: idle gaps 10–12 and 20–25
KERNELS = [("k1", 0, 10 * MS), ("k2", 12 * MS, 8 * MS),
           ("k3", 25 * MS, 15 * MS)]
# CUDA runtime calls: 1–3 and 2–4 overlap (one call of 3 ms merged),
# 30–35, 45–50; the window runs 0–50 ms
HOST_OPS = [("cudaLaunchKernel", 1 * MS, 2 * MS),
            ("cudaLaunchKernel", 2 * MS, 2 * MS),
            ("cudaLaunchKernel", 30 * MS, 5 * MS),
            ("cudaMemcpyAsync", 45 * MS, 5 * MS)]


def sp(name, a_ms, b_ms, device_ms=None, work=None, parent=0):
    return {"name": name, "start_ns": int(a_ms * MS), "end_ns": int(b_ms * MS),
            "device_ms": device_ms, "work": work,
            "parent": None if name == "step" else parent}


SPANS = [
    sp("step", 0.5, 21.0),
    sp("fwd", 0.6, 5.0, 4.0, 100), sp("bwd", 5.0, 11.0, 6.5, 100),
    sp("fwd", 11.0, 13.0, 1.5, 100), sp("update", 13.0, 14.0, 0.25, 10 ** 8),
    sp("gossip", 14.0, 15.0, 0.5, 10 ** 8),
    sp("step", 22.0, 48.0),
    sp("fwd", 22.5, 30.0, 4.5, 100), sp("bwd", 30.0, 40.0, 7.5, 100),
    sp("fwd", 40.0, 42.0, 1.0, 100), sp("update", 42.0, 43.0, 0.75, 10 ** 8),
    sp("gossip", 43.0, 44.0, 0.5, 10 ** 8),
    sp("fwd", 60.0, 70.0, 100.0, 100),  # after the window's last event
]


@pytest.fixture
def trace(monkeypatch):
    calls = []

    def fake():
        calls.append(1)
        return list(SPANS)

    monkeypatch.setattr(lanes, "_program_spans", fake)
    tr = Trace(2, 0.05, KERNELS, HOST_OPS)
    tr.calls = calls
    return tr


@pytest.mark.parametrize("name, want", [
    ("fwd_ms_per_step", (4.0 + 1.5 + 4.5 + 1.0) / 2),  # 60–70 ms left out
    ("bwd_ms_per_step", (6.5 + 7.5) / 2),
    ("update_ms_per_step", (0.25 + 0.75) / 2),
    ("gossip_ms_per_step", (0.5 + 0.5) / 2),
    # step 1: 20.5 ms less the merged 1–4 ms call; step 2: 26 ms less
    # 30–35 and 45–48 (the call past the span's end is cut at it)
    ("host_dispatch_ms_per_step", ((20.5 - 3.0) + (26.0 - 5.0 - 3.0)) / 2),
    # step 1 holds the 10–12 gap and 20–21 of the 20–25 one; step 2 holds
    # 22–25 of it
    ("dispatch_idle_ms_per_step", ((2.0 + 1.0) + 3.0) / 2),
])
def test_readers_hand_worked(trace, name, want):
    assert metrics.read(name, {"trace": trace}) == pytest.approx(want)


def test_inner_step_counted_once(monkeypatch):
    """An engine's ``step`` span inside another's adds no host time and no
    idle: only the outermost ``step`` spans count."""
    inner = dict(sp("step", 1.0, 20.0), parent=0)
    monkeypatch.setattr(lanes, "_program_spans", lambda: SPANS + [inner])
    tr = Trace(2, 0.05, KERNELS, HOST_OPS)
    assert metrics.read("host_dispatch_ms_per_step", {"trace": tr}) == \
        pytest.approx(((20.5 - 3.0) + (26.0 - 5.0 - 3.0)) / 2)
    assert metrics.read("dispatch_idle_ms_per_step", {"trace": tr}) == \
        pytest.approx(((2.0 + 1.0) + 3.0) / 2)


def test_work_readers_hand_worked(trace):
    # four fwd spans of 100 tokens inside the window, two steps
    assert lanes.work_per_step(trace, "fwd") == 200
    assert lanes.work_per_step(trace, "update") == 10 ** 8
    # 0.5 ms a step against one pass of 1e8 f32 elements at 3.35 TB/s
    # (0.1194 ms)
    assert lanes.passes_at_peak(trace, "update", 4) == pytest.approx(
        0.5e-3 * 3.35e12 / (4 * 10 ** 8))
    assert lanes.passes_at_peak(trace, "drift", 4) is None


def test_work_readers_none_without_counts(monkeypatch):
    uncounted = [dict(s, work=None) for s in SPANS]
    monkeypatch.setattr(lanes, "_program_spans", lambda: uncounted)
    tr = Trace(2, 0.05, KERNELS, HOST_OPS)
    assert lanes.work_per_step(tr, "fwd") is None
    assert lanes.passes_at_peak(tr, "update", 4) is None


def test_record_read_once_per_trace(trace):
    for name in LANE_METRICS:
        metrics.read(name, {"trace": trace})
    assert len(trace.calls) == 1
    assert len(lanes.spans(trace)) == len(SPANS) - 1


@pytest.mark.parametrize("name", LANE_METRICS)
def test_none_without_spans(monkeypatch, name):
    monkeypatch.setattr(lanes, "_program_spans", lambda: [])
    assert metrics.read(name, {"trace": Trace(2, 0.05, KERNELS,
                                              HOST_OPS)}) is None


@pytest.mark.parametrize("name", LANE_METRICS)
def test_none_with_spans_outside_the_window(monkeypatch, name):
    late = [dict(s, start_ns=s["start_ns"] + 100 * MS,
                 end_ns=s["end_ns"] + 100 * MS) for s in SPANS]
    monkeypatch.setattr(lanes, "_program_spans", lambda: late)
    assert metrics.read(name, {"trace": Trace(2, 0.05, KERNELS,
                                              HOST_OPS)}) is None


@pytest.mark.parametrize("name", LANE_METRICS[:4])
def test_none_without_device_times(monkeypatch, name):
    """Spans of a run off CUDA carry no device times."""
    cpu = [dict(s, device_ms=None) for s in SPANS]
    monkeypatch.setattr(lanes, "_program_spans", lambda: cpu)
    assert metrics.read(name, {"trace": Trace(2, 0.05, KERNELS,
                                              HOST_OPS)}) is None


def test_program_without_span_record(monkeypatch):
    """A program that predates the lane spans gives no spans, and the
    readers None, without raising."""
    monkeypatch.setitem(sys.modules, "repro_torch.launch.timeline", None)
    assert lanes._program_spans() == []
    tr = Trace(2, 0.05, KERNELS, HOST_OPS)
    assert all(metrics.read(n, {"trace": tr}) is None for n in LANE_METRICS)


def _lane_split():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[2] / "tools" / "lane_split.py"
    spec = importlib.util.spec_from_file_location("lane_split", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lane_split_follows_parent_links(monkeypatch):
    """``tools/lane_split.py`` places each kernel down the parent links
    from its ``step`` span, and sets each lane's device time against its
    work."""
    ls = _lane_split()
    tree_spans = [dict(s, id=i, worker=None, slice=None)
                  for i, s in enumerate(SPANS)]
    for s in tree_spans:  # each lane's parent: its own step span
        if s["name"] != "step":
            s["parent"] = 0 if s["start_ns"] < 21 * MS else 6
    # a span of another thread, at the same time as step 1's bwd, with no
    # parent: the kernels launched inside bwd stay with bwd
    tree_spans.insert(0, dict(sp("gossip", 4.0, 12.0, 0.0, 10 ** 8), id=99,
                              parent=None, worker=None, slice=None))
    tree = ls.children(tree_spans)
    assert ls.innermost(tree, 8 * MS)["name"] == "bwd"
    assert ls.innermost(tree, 21.5 * MS) is None
    assert ls.innermost(tree, 47 * MS)["name"] == "step"
    monkeypatch.setattr(lanes, "_program_spans", lambda: tree_spans)
    tr = Trace(2, 0.05, KERNELS, HOST_OPS)
    launched = {0: 2 * MS, 1: 8 * MS, 2: 47 * MS}
    out = ls.split(tr, launched, lanes.spans(tr), 4)
    got = out["lanes"]
    assert got["fwd"]["kernel_ms_per_step"] == {"elementwise": 5.0}
    assert got["bwd"]["kernel_ms_per_step"] == {"elementwise": 4.0}
    assert got["outside lanes"]["kernel_ms_per_step"] == {
        "elementwise": 7.5}
    assert got["fwd"]["us_per_token"] == pytest.approx(
        (4.0 + 1.5 + 4.5 + 1.0) / 2 * 1e3 / 200)
    assert got["update"]["passes_at_peak"] == pytest.approx(
        0.5e-3 * 3.35e12 / (4 * 10 ** 8))
    assert out["coverage"]["launch_calls_in_step"] == 3
