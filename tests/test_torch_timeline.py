"""Lane spans inside the port's decoupled step
(``repro_torch.launch.timeline``), on a tiny dense model, M=2, R=2, D=1,
on the fused (``use_pallas``) and plain routes.

(a) Off without a profiler: nothing is recorded, no host clock is read,
    no CUDA event is made and no work is counted (all replaced by
    functions that raise), and ``span`` hands back one shared no-op
    context.
(b) Under ``torch.profiler`` (CPU activity): one ``step`` span a step,
    whose children are ``fwd`` for every (worker, slice), ``bwd`` and
    ``pack`` for every worker, ``update``, ``gossip`` and ``drift``, each
    inside its parent's interval, with their work counts; the profiler's
    matrix products of each worker fall inside that worker's ``fwd`` or
    ``bwd`` spans, and every op of the step inside its ``step`` span, on
    the shared clock.
(c) Losses and planes are bit-identical with the profiler on and off.
(d) The pipeline engine (``overlap=True``) records the same span names;
    the stream engine's spans nest per thread.
(e) The work counts: an int, a tensor, a batch's labels, a plane.
(f) The record: the cap drops the oldest spans, a read clears the record
    and the clock anchor (a span open across it keeps its own), the
    anchor's arithmetic, and the moved
    ``StageTimeline`` and ``_DeviceClock`` are the ones the engines use.
"""
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.backend import make_backend  # noqa: E402
from repro_torch.launch import pipeline, streams, timeline  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import constant, momentum  # noqa: E402

M, R, D, B, S, VOCAB = 2, 2, 1, 4, 16, 128
LANES = {"fwd", "bwd", "pack", "update", "gossip", "drift"}


@pytest.fixture(scope="module")
def model_params():
    cfg = reduced(get_config("gpt2-medium")).with_(
        num_layers=1, d_model=64, d_ff=128, vocab_size=VOCAB, num_heads=2,
        num_kv_heads=2)
    model = build_model(cfg)
    return model, model.init(seed=0, device="cpu")


def _batches(steps):
    gen = torch.Generator().manual_seed(7)
    out = []
    for _ in range(steps):
        t = torch.randint(0, VOCAB, (M, B, S + 1), generator=gen)
        out.append({"tokens": t[..., :-1], "labels": t[..., 1:]})
    return out


def _run(model_params, steps=3, profiled=(), **kw):
    """The prod backend over ``steps`` batches; the steps in ``profiled``
    run under the profiler. Returns (losses, read plane, profiler events
    of the profiled steps, spans)."""
    model, params = model_params
    be = make_backend("prod", "layup", M=M, loss_fn=model.loss_fn,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      fb_ratio=R, update_delay=D, device="cpu",
                      wait_timeout_s=20.0, **kw)
    timeline.lane_spans()  # an empty record to start from
    events, losses = [], []
    try:
        st = be.init(None, params)
        for t, b in enumerate(_batches(steps)):
            if t in profiled:
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    st, m = be.step(st, b)
                    if hasattr(be.engine, "finalize"):
                        be.engine.finalize()  # the stream tasks, run
                events += list(prof.profiler.kineto_results.events())
            else:
                st, m = be.step(st, b)
            losses.append(float(m["loss"]))
        read = st["read"]
        if hasattr(be.engine, "materialize"):
            read = be.engine.materialize(read)
            be.engine.finalize()
        read = {k: v.clone() for k, v in read.items()}
    finally:
        if hasattr(be.engine, "close"):
            be.engine.close()
    return losses, read, events, timeline.lane_spans()


ROUTES = {"fused": dict(use_pallas=True), "plain": dict(use_pallas=False)}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_off_without_a_profiler(model_params, monkeypatch, route):
    def boom(*a, **k):
        raise AssertionError("read or made while the profiler is off")

    monkeypatch.setattr(timeline, "_perf_ns", boom)
    monkeypatch.setattr(timeline, "_real_ns", boom)
    monkeypatch.setattr(timeline, "_count", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    assert timeline.span("fwd", step=0) is timeline.span("gossip", step=1)
    _, _, _, spans = _run(model_params, **ROUTES[route])
    assert spans == []


def _children(spans, step):
    return [s for s in spans if s["parent"] == step["id"]]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_step_span_tree(model_params, route):
    _, read, _, spans = _run(model_params, profiled=(1, 2), **ROUTES[route])
    steps = [s for s in spans if s["name"] == "step"]
    assert [s["step"] for s in steps] == [1, 2]
    assert len(spans) == 2 * (1 + M * R + 2 * M + 3)
    plane = sum(v.numel() for v in read.values())
    tokens = (B // R) * S
    for st in steps:
        kids = _children(spans, st)
        assert {(s["name"], s["worker"], s["slice"]) for s in kids} == (
            {("fwd", m, r) for m in range(M) for r in range(R)}
            | {("bwd", m, 0) for m in range(M)}
            | {("pack", m, None) for m in range(M)}
            | {("update", None, None), ("gossip", None, None),
               ("drift", None, None)})
        assert len(kids) == len(spans) // 2 - 1
        for s in kids:
            assert st["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= st["end_ns"]
            assert s["step"] == st["step"] and s["device_ms"] is None
            want = {"fwd": tokens, "bwd": tokens, "pack": plane // M}.get(
                s["name"], plane)
            assert s["work"] == want, s
        lanes = sorted(kids, key=lambda s: s["start_ns"])
        for a, b in zip(lanes, lanes[1:]):  # one thread: no two overlap
            assert a["end_ns"] <= b["start_ns"]


MATMULS = ("aten::mm", "aten::addmm", "aten::bmm")


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_profiler_ops_inside_their_spans(model_params, route):
    """On the shared clock: each worker's matrix products inside its own
    ``fwd`` or ``bwd`` spans (the same count for each worker), and every
    op of a step inside its ``step`` span but the batch's ``aten::to``
    (a no-op on the device the batch is on, before the step)."""
    _, _, events, spans = _run(model_params, profiled=(1,), **ROUTES[route])
    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in events if e.name().startswith("aten::")]
    (step,) = [s for s in spans if s["name"] == "step"]
    outside = {n for n, a, b in ops
               if not step["start_ns"] <= a <= b <= step["end_ns"]}
    assert outside <= {"aten::to"}
    lanes = [s for s in spans if s["name"] in ("fwd", "bwd")]
    per_worker = {m: 0 for m in range(M)}
    for n, a, b in ops:
        if n not in MATMULS:
            continue
        (lane,) = [s for s in lanes if s["start_ns"] <= a <= b
                   <= s["end_ns"]]
        per_worker[lane["worker"]] += 1
    assert per_worker[0] == per_worker[1] > 0


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_bit_identical_with_profiler_on_and_off(model_params, route):
    off = _run(model_params, **ROUTES[route])
    on = _run(model_params, profiled=(0, 1, 2), **ROUTES[route])
    assert on[0] == off[0]
    for k in off[1]:
        assert torch.equal(on[1][k], off[1][k]), k
    assert len(on[3]) == 3 * (1 + M * R + 2 * M + 3)


def test_pipeline_engine_records_the_same_spans(model_params):
    mono = _run(model_params, profiled=(1,), use_pallas=True)
    pipe = _run(model_params, profiled=(1,), use_pallas=True, overlap=True)
    assert pipe[0] == mono[0]
    key = lambda s: (s["name"], s["worker"], s["slice"])  # noqa: E731
    assert sorted(map(key, pipe[3]), key=str) == sorted(map(key, mono[3]),
                                                        key=str)
    (step,) = [s for s in pipe[3] if s["name"] == "step"]
    assert {s["name"] for s in _children(pipe[3], step)} == LANES


def test_stream_engine_spans_nest_per_thread(model_params):
    _, _, _, spans = _run(model_params, profiled=(1,), use_pallas=True,
                          overlap=True, streams=2)
    assert {s["name"] for s in spans} == LANES | {"step"}
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["parent"] is not None:
            parent = by_id[s["parent"]]
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= parent["end_ns"]
    # the host's step span holds the submission only; the lanes run on the
    # stream threads, whose stacks hold no span of the host's, the update
    # and gossip spans tagged with their step
    assert all(s["parent"] is None for s in spans
               if s["name"] in ("fwd", "bwd", "update", "gossip"))
    assert {s["step"] for s in spans
            if s["name"] in ("update", "gossip", "drift")} == {1}


def test_work_counts():
    batch = {"tokens": torch.zeros(3, 5), "labels": torch.zeros(3, 5)}
    plane = {"blocks": torch.zeros(2, 7), "embed": torch.zeros(2, 4)}
    assert [timeline._count(w) for w in (None, 9, torch.zeros(4, 6), batch,
                                         plane)] == [None, 9, 24, 15, 22]


def _fake_clocks(monkeypatch):
    perf = iter(range(1000, 10 ** 6, 10))
    real = iter(range(5 * 10 ** 9, 6 * 10 ** 9, 10 ** 6))
    monkeypatch.setattr(timeline, "_perf_ns", lambda: next(perf))
    monkeypatch.setattr(timeline, "_real_ns", lambda: next(real))
    monkeypatch.setattr(timeline, "spans_on", lambda: True)


def test_anchor_places_spans_on_the_profilers_clock(monkeypatch):
    """Perf readings 1000, 1010, ...: the first span takes the anchor
    (perf 1000, real 5e9), opens at 1010 and its child at 1020; a read
    clears the anchor, so the next span takes a fresh pair."""
    _fake_clocks(monkeypatch)
    monkeypatch.setattr(timeline, "LANES", timeline.StageTimeline())
    with timeline.span("step", step=4):
        with timeline.span("fwd", worker=1, slice=0, work=32):
            pass
    child, parent = timeline.lane_spans()
    assert (parent["start_ns"], child["start_ns"], child["end_ns"],
            parent["end_ns"]) == tuple(5 * 10 ** 9 + d
                                       for d in (10, 20, 30, 40))
    assert child["parent"] == parent["id"] and parent["parent"] is None
    assert child["step"] == 4 and child["work"] == 32
    assert timeline.lane_spans() == []
    with timeline.span("step", step=5):
        pass
    (again,) = timeline.lane_spans()
    # anchor (1050, 5e9 + 1e6), open at 1060
    assert again["start_ns"] == 5 * 10 ** 9 + 10 ** 6 + 10


def test_span_open_across_a_read_keeps_its_anchor(monkeypatch):
    """A read while a span is open (a stream thread's) clears the anchor;
    the span, closed later, is placed by the anchor it opened with."""
    _fake_clocks(monkeypatch)
    monkeypatch.setattr(timeline, "LANES", timeline.StageTimeline())
    with timeline.span("gossip", step=2):
        assert timeline.lane_spans() == []
    (sp,) = timeline.lane_spans()
    # anchor (1000, 5e9), open at 1010, closed at 1020
    assert (sp["start_ns"], sp["end_ns"]) == (5 * 10 ** 9 + 10,
                                              5 * 10 ** 9 + 20)


def test_record_is_bounded(monkeypatch):
    _fake_clocks(monkeypatch)
    monkeypatch.setattr(timeline, "SPAN_CAP", 3)
    monkeypatch.setattr(timeline, "LANES", timeline.StageTimeline())
    for t in range(5):
        with timeline.span("step", step=t):
            pass
    assert [s["step"] for s in timeline.lane_spans(clear=False)] == [2, 3, 4]
    assert [s["step"] for s in timeline.lane_spans()] == [2, 3, 4]
    assert timeline.lane_spans() == []


def test_moved_timeline_is_the_engines(tmp_path, monkeypatch):
    """``StageTimeline`` and ``_DeviceClock`` live in ``launch.timeline``;
    the pipeline module still exports the timeline, and ``dump`` writes
    the lane spans beside the events."""
    import json

    assert pipeline.StageTimeline is timeline.StageTimeline
    assert streams.StageTimeline is timeline.StageTimeline
    assert streams._DeviceClock is timeline._DeviceClock
    _fake_clocks(monkeypatch)
    tl = timeline.StageTimeline()
    monkeypatch.setattr(timeline, "LANES", tl)
    with timeline.span("update", step=0, work=9):
        pass
    with open(tl.dump(str(tmp_path / "t.json"))) as f:
        doc = json.load(f)
    assert doc["events"] == [] and doc["summary"]["steps"] == 0
    assert [s["name"] for s in doc["spans"]] == ["update"]
    assert doc["spans"][0]["work"] == 9
