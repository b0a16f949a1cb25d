"""The port's stage autotuner against ``repro.launch.tuner``.

* Pure functions EQUAL to the JAX package's on the same inputs:
  ``score_candidate``, ``build_record`` (the whole record),
  ``apply_tuning``, ``stage_floors``, ``overlap_efficiency``,
  ``stage_times_from_cutouts``, ``enumerate_grid``; the reference's pinned
  values reproduced.
* A record file written by either package loads in the other.
* Cutouts of the port's engines (their abstract signatures are ``(shape,
  dtype)`` pairs, ``int`` and ``None``), ``synthesize_args`` on a device,
  the harness with a scripted clock and runner, a live CPU engine's
  cutouts timed for real, and ``ProdTrainerBackend(tuning=...)``.
"""
import itertools
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _fixtures import mlp_batch  # noqa: E402
from _torch_parity import mlp_params, np_tree, torch_mlp_loss  # noqa: E402
from repro.launch import analysis as JA  # noqa: E402
from repro.launch import tuner as J  # noqa: E402
from repro_torch.core.backend import make_backend  # noqa: E402
from repro_torch.launch import analysis as TA  # noqa: E402
from repro_torch.launch import tuner as T  # noqa: E402
from repro_torch.launch.pipeline import PipelineEngine  # noqa: E402
from repro_torch.launch.streams import StreamEngine  # noqa: E402
from repro_torch.optim import constant, momentum  # noqa: E402

F32 = torch.float32
TIMES = {"fwd": 1.0, "update": 2.0, "gossip": 2.0}


def _fake_abstract_args(with_groups=False):
    plane = {"l1": ((1, 8), F32), "l2": ((1, 4), F32)}
    batch = {"x": ((1, 4, 2), F32)}
    out = {"fwd": (plane, batch),
           "update": (plane, plane, plane, None, int),
           "gossip": (plane, ((1,), F32), int)}
    if with_groups:
        for g in ("l1", "l2"):
            out[f"mix:{g}"] = (plane[g], ((1,), F32), int)
        out["clock"] = (((1,), F32), int)
    return out


def _cand_pairs():
    return [(T.Candidate(**kw), J.Candidate(**kw)) for kw in (
        {}, dict(R=1, D=0), dict(R=4, D=2, max_inflight_steps=4),
        dict(grouping="legacy"), dict(tile=32), dict(tile=512))]


# ---------------------------------------------------------------------------
# the pure functions against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("times", [TIMES, {"fwd": 1.0, "update": 0.1,
                                           "gossip": 0.1}])
@pytest.mark.parametrize("timeline", [None, {"wall_s": 10.0,
                                             "exec_overlap_s": 4.0},
                                      {"wall_s": 0.0}])
def test_score_candidate_equals_jax(times, timeline):
    floors = {"fwd": 0.9, "update": 0.0, "gossip": 2.5}
    for tc, jc in _cand_pairs():
        for fl in (None, floors):
            for pen in (0.1, 1.0):
                assert T.score_candidate(
                    tc, times, floors=fl, timeline=timeline,
                    staleness_penalty=pen) == J.score_candidate(
                    jc, times, floors=fl, timeline=timeline,
                    staleness_penalty=pen)


def test_build_record_equals_jax():
    timeline = {"wall_s": 10.0, "fwd_gossip_overlap_s": 3.0}

    def entries(mod):
        return [(mod.Candidate(**kw), TIMES, timeline) for kw in (
            {}, dict(R=1, D=0), dict(R=4, D=2, max_inflight_steps=4))]

    def floors(c):
        return {"fwd": 0.5 / c.R, "update": 1.0, "gossip": 0.0}

    got = T.build_record(entries(T), key="k", floors=floors,
                         meta={"steps": 3})
    want = J.build_record(entries(J), key="k", floors=floors,
                          meta={"steps": 3})
    assert got.to_dict() == want.to_dict()
    assert T.TUNING_SCHEMA_VERSION == J.TUNING_SCHEMA_VERSION == 1


def test_grid_and_stage_times_equal_jax():
    assert ([c.label() for c in T.enumerate_grid()]
            == [c.label() for c in J.enumerate_grid()])
    timings = {"fwd0": {"mean_s": 1.0}, "update": {"mean_s": 2.0},
               "mix:l1": {"mean_s": 0.5}, "clock": {"mean_s": 0.25}}
    assert (T.stage_times_from_cutouts(timings)
            == J.stage_times_from_cutouts(timings))
    for tl in (None, {}, {"wall_s": 2.0, "overlap_s": 5.0}):
        assert T.overlap_efficiency(tl) == J.overlap_efficiency(tl)


@pytest.mark.parametrize("R", [1, 2, 4])
def test_stage_floors_equal_jax(R):
    kw = dict(t_compute=4.0, t_memory=2.0, t_collective=1.0)
    t, j = TA.RooflineReport(**kw), JA.RooflineReport(**kw)
    assert TA.stage_floors(t, R=R) == JA.stage_floors(j, R=R)
    assert TA.stage_floors(t.to_dict(), R=R) == JA.stage_floors(
        j.to_dict(), R=R)
    assert t.to_dict() == j.to_dict()


@pytest.mark.parametrize("best", [{}, dict(grouping="legacy"),
                                  dict(R=4, D=2, max_inflight_steps=4)])
def test_apply_tuning_equals_jax(best):
    b = {"R": 2, "D": 1, "grouping": "layer", "max_inflight_steps": 3,
         "tile": 128, **best}
    rec = dict(version=1, key="k", best=b, score=1.0)
    for kw in ({}, dict(fb_ratio=3), dict(update_delay=2, flat=True),
               dict(max_inflight_steps=8)):
        assert (T.apply_tuning(T.TuningRecord(**rec), **kw)
                == J.apply_tuning(J.TuningRecord(**rec), **kw))
    assert T.apply_tuning(None, fb_ratio=3) == J.apply_tuning(None,
                                                              fb_ratio=3)


def test_record_files_load_across_packages(tmp_path):
    jrec = J.build_record([(J.Candidate(), TIMES, None)], key="x|y|wire=param")
    trec = T.build_record([(T.Candidate(), TIMES, None)], key="x|y|wire=param")
    jpath = jrec.save(str(tmp_path / "j.json"))
    tpath = trec.save(str(tmp_path / "t.json"))
    assert open(jpath).read() == open(tpath).read()
    assert T.load_tuning(jpath, key=jrec.key).to_dict() == jrec.to_dict()
    assert J.load_tuning(tpath, key=trec.key).to_dict() == trec.to_dict()


# ---------------------------------------------------------------------------
# the reference's pinned values and contracts, on the port
# ---------------------------------------------------------------------------


def test_exact_value_default_candidate():
    s = T.score_candidate(T.Candidate(R=2, D=1, max_inflight_steps=3),
                          TIMES)
    assert s["serial_s"] == pytest.approx(6.0)
    assert s["critical_s"] == pytest.approx(4.0)
    assert s["step_time_s"] == pytest.approx(4.125)
    assert s["staleness"] == pytest.approx(1.5)
    assert s["score"] == pytest.approx(2.0 / 4.125 / 1.15)


def test_record_round_trip_and_fallbacks(tmp_path):
    rec = T.build_record([(T.DEFAULT_CANDIDATE, TIMES, None),
                          (T.Candidate(R=1, D=0), TIMES, None)], key="k",
                         meta={"steps": 4})
    path = rec.save(str(tmp_path / "rec.json"))
    assert T.load_tuning(path, key="k").to_dict() == rec.to_dict()
    with pytest.warns(UserWarning, match="keyed"):
        assert T.load_tuning(path, key="other") is None
    with pytest.warns(UserWarning, match="tuning record"):
        assert T.load_tuning(str(tmp_path / "nope.json")) is None
    bad = tmp_path / "bad.json"
    bad.write_text("{not json!!")
    with pytest.warns(UserWarning, match="unreadable"):
        assert T.load_tuning(str(bad)) is None
    doc = rec.to_dict()
    doc["version"] = 99
    bad.write_text(json.dumps(doc))
    with pytest.warns(UserWarning, match="stale"):
        assert T.load_tuning(str(bad)) is None
    assert T.resolve_tuning(None) is None and T.resolve_tuning(rec) is rec
    with pytest.warns(UserWarning, match="keyed"):
        assert T.resolve_tuning(rec, key="other") is None


def test_key_and_descriptors():
    from repro_torch.core.layerview import FlatPartition

    part = FlatPartition({"l1": torch.zeros(16, 32),
                          "l2": torch.zeros(32, 10)})
    assert T.problem_descriptor(part) == "plane[l1:512,l2:320]"
    assert T.mesh_descriptor("cpu", 4) == "cpu:M4"
    assert (T.make_key(T.problem_descriptor(part), T.mesh_descriptor(
        "cpu", 4), "int8") == "plane[l1:512,l2:320]|cpu:M4|wire=int8")


# ---------------------------------------------------------------------------
# cutouts, synthesized arguments, the harness
# ---------------------------------------------------------------------------


def test_synthesize_args_makes_fresh_ones_on_the_device():
    args = (((3, 4), torch.bfloat16), {"a": ((), torch.int32)},
            (((2,), F32), ((2,), F32)), int, None)
    got = T.synthesize_args(args, "cpu")
    assert got[0].shape == (3, 4) and got[0].dtype == torch.bfloat16
    assert got[1]["a"].shape == () and int(got[1]["a"]) == 1
    assert isinstance(got[2], tuple) and len(got[2]) == 2
    assert bool((got[0] == 1).all())
    assert got[3] == 1 and got[4] is None
    again = T.synthesize_args(args, "cpu")
    assert again[0] is not got[0]  # never reuse a consumed buffer
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.synthesize_args(args)


def test_pipeline_engine_cutouts():
    fns = [lambda *a: ("fwd0", a), lambda *a: ("fwd1", a)]
    upd, gos = (lambda *a: ("upd", a)), (lambda *a: ("gos", a))
    eng = PipelineEngine(R=2, D=1, M=1, device="cpu",
                         stages={"fwd": fns, "update": upd, "gossip": gos},
                         abstract_args=_fake_abstract_args())
    cuts = T.extract_cutouts(eng)
    assert set(cuts) == {"fwd0", "fwd1", "update", "gossip"}
    assert cuts["fwd0"].fn is fns[0] and cuts["update"].fn is upd
    assert cuts["fwd0"].abstract_args == eng.abstract_args["fwd"]
    assert cuts["gossip"].device == torch.device("cpu")
    tag, args = cuts["update"].fn(*T.synthesize_args(
        cuts["update"].abstract_args, cuts["update"].device))
    assert tag == "upd" and len(args) == 5 and args[3] is None


def test_engine_without_abstract_args_or_batch_raises():
    stages = {"fwd": [lambda *a: a], "update": lambda *a: a,
              "gossip": lambda *a: a}
    with pytest.raises(ValueError, match="abstract args"):
        T.extract_cutouts(PipelineEngine(R=1, D=0, M=1, device="cpu",
                                         stages=stages))
    absargs = _fake_abstract_args()
    absargs["fwd"] = (absargs["fwd"][0], None)
    with pytest.raises(ValueError, match="batch"):
        T.extract_cutouts(PipelineEngine(R=1, D=0, M=1, device="cpu",
                                         stages=stages,
                                         abstract_args=absargs))


def test_stream_engine_cutouts():
    mixes = {"l1": lambda *a: a, "l2": lambda *a: a}
    eng = StreamEngine(
        R=2, D=0, M=1, group_names=["l1", "l2"], device="cpu",
        stages={"fwd": [lambda *a: a, lambda *a: a],
                "update": lambda *a: a, "gossip": lambda *a: a},
        group_stages={"mix": mixes, "clock": lambda *a: a}, n_streams=2,
        abstract_args=_fake_abstract_args(with_groups=True),
        wait_timeout_s=20.0)
    try:
        cuts = T.extract_cutouts(eng)
        assert set(cuts) == {"fwd0", "fwd1", "update", "mix:l1", "mix:l2",
                             "clock"}
        assert cuts["mix:l1"].fn is mixes["l1"]
    finally:
        eng.close()


def _cutout():
    return T.StageCutout("update", lambda *a: ("out", a),
                         (((4,), F32), int), "cpu")


def test_scripted_clock_exact_arithmetic():
    clk = itertools.count()
    calls = []
    h = T.CutoutHarness(clock=lambda: float(next(clk)),
                        runner=lambda fn, args: calls.append(args),
                        warmup=1, reps=3)
    assert h.time_cutout(_cutout()) == {"mean_s": 1.0, "best_s": 1.0,
                                        "reps": 3.0}
    assert len(calls) == 4  # warmup + 3 measured reps
    assert calls[0][0] is not calls[1][0] and calls[1][1] == 1


def test_variable_clock_mean_and_best():
    ticks = iter([0.0, 3.0, 10.0, 11.0])
    h = T.CutoutHarness(clock=lambda: next(ticks),
                        runner=lambda fn, args: None, warmup=0, reps=2)
    t = h.time_cutout(_cutout())
    assert t["mean_s"] == pytest.approx(2.0)
    assert t["best_s"] == pytest.approx(1.0)
    with pytest.raises(ValueError, match="rep"):
        T.CutoutHarness(reps=0)


def test_default_clock_is_the_host_clock_on_the_cpu():
    import time

    assert T.default_clock("cpu") is time.perf_counter
    assert T.CutoutHarness()._clock_for(torch.device("cpu")) \
        is time.perf_counter


def _backend(**kw):
    return make_backend("prod", "layup", loss_fn=torch_mlp_loss,
                        optimizer=momentum(0.9), schedule=constant(0.05),
                        measure_drift=False, device="cpu",
                        wait_timeout_s=20.0, **kw)


@pytest.mark.parametrize("M,streams", [(1, 1), (4, 1), (4, 2)])
def test_cutouts_from_a_live_engine_run(M, streams):
    """A real engine's cutouts run on synthesized inputs and time with the
    default clock and runner; the stage times score a record."""
    be = _backend(M=M, overlap=True, fb_ratio=2, update_delay=1,
                  use_pallas=True, streams=streams)
    try:
        st = be.init(None, mlp_params())
        with pytest.raises(ValueError, match="batch"):
            T.extract_cutouts(be.engine)
        for t in range(2):
            st, m = be.step(st, np_tree(mlp_batch(t, M=M, b=8)))
        float(m["loss"])
        cuts = T.extract_cutouts(be.engine)
        want = {"fwd0", "fwd1", "update"} | (
            {"gossip"} if streams == 1 else
            {"clock"} | {f"mix:{g}" for g in be.part.group_sizes})
        assert set(cuts) == want
        h = T.CutoutHarness(warmup=1, reps=1)
        timings = h.time_engine(be.engine)
        times = T.stage_times_from_cutouts(timings)
        assert all(v > 0.0 for v in times.values())
        rec = T.build_record(
            [(T.Candidate(R=2, D=1), times, be.timeline.summary())],
            key=T.make_key(T.problem_descriptor(be.part),
                           T.mesh_descriptor("cpu", M), be.wire))
        assert rec.score > 0.0
    finally:
        if streams > 1:
            be.engine.close()


# ---------------------------------------------------------------------------
# ProdTrainerBackend(tuning=...)
# ---------------------------------------------------------------------------


def _record(R=2, D=1, q=4, grouping="layer"):
    return T.TuningRecord(
        version=T.TUNING_SCHEMA_VERSION, key="unit",
        best={"R": R, "D": D, "grouping": grouping,
              "max_inflight_steps": q, "tile": 128}, score=1.0)


def test_record_configures_engine_and_implies_overlap(tmp_path):
    path = _record().save(str(tmp_path / "rec.json"))
    for tuning in (_record(), path):
        be = _backend(M=1, tuning=tuning)
        assert be.overlap and be.tuning is not None
        st = be.init(None, mlp_params())
        assert be.engine.R == 2 and be.engine.D == 1
        assert be.engine.max_inflight_steps == 4
        for t in range(3):
            st, m = be.step(st, np_tree(mlp_batch(t, M=1, b=8)))
        assert np.isfinite(float(m["loss"]))


def test_explicit_kwargs_beat_the_record():
    be = _backend(M=1, tuning=_record(R=4, D=2), fb_ratio=2, update_delay=1)
    be.init(None, mlp_params())
    assert be.engine.R == 2 and be.engine.D == 1
    assert be.engine.max_inflight_steps == 4  # untouched default: tuned


def test_bad_record_path_warns_and_keeps_defaults(tmp_path):
    with pytest.warns(UserWarning, match="tuning record"):
        be = _backend(M=1, tuning=str(tmp_path / "missing.json"))
    assert not be.overlap and be.tuning is None
    st = be.init(None, mlp_params())
    st, m = be.step(st, np_tree(mlp_batch(0, M=1, b=8)))
    assert np.isfinite(float(m["loss"]))


def test_legacy_record_reaches_the_flat_guard():
    """A record whose best grouping is ``"legacy"`` once reached the
    ``flat=False`` guard; the port now runs ``flat=False`` on the flat
    plane, its one state layout, so the record trains: the pipeline
    engine."""
    be = _backend(M=2, tuning=_record(grouping="legacy"))
    assert be.overlap and be.tuning is not None
    st = be.init(None, mlp_params())
    st, m = be.step(st, np_tree(mlp_batch(0, M=2, b=8)))
    assert np.isfinite(float(m["loss"]))
    assert "pipeline backend (M=2" in be.engine.describe
    assert sorted(be.export_params(st)) == ["l1", "l2"]
