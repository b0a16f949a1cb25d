"""The port's stage-graph pipeline engine (``overlap=True``) against the
port's monolithic step and against the JAX package's engine.

(a) Inside the port, bit-exact: loss, staleness, disagreement, Σw and the
    final read plane of ``make_backend(..., overlap=True)`` equal the
    monolithic step's at (R, D) ∈ {(1,0), (1,1), (2,1)}, M ∈ {1, 4}, on the
    fused and unfused routes, with a straggler mask, and with the int8 wire
    and delay compensation (λ=0.5). The engine runs the same lane closures
    in the same order, so nothing may differ by a bit.
(b) Against the JAX engine at M=1 in process (Pallas in interpret mode),
    on the MLP fixture and on the ``_bench_cfg`` decoder, within
    ``_torch_parity.py``'s tolerances.
(c) ``StageTimeline``: the same synthetic event lists through the JAX
    package's timeline and the port's give equal ``summary()`` dicts.
(d) Mechanics: the backpressure bound, the summary keys against JAX's,
    the stage signatures against ``repro.launch.pipeline.
    flat_abstract_args``, the guards of what is not ported.
"""
import itertools
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _fixtures import mlp_batch, mlp_problem  # noqa: E402
from _torch_parity import (assert_runs_equal, compare_metrics,  # noqa: E402,E501
                           compare_planes, materialize, mlp_params, np_tree,
                           run_port, torch_mlp_loss)
from repro.core.backend import make_backend as jax_make_backend  # noqa: E402
from repro.core.layerview import FlatPartition as JaxFlatPartition  # noqa: E402,E501
from repro.launch.pipeline import StageTimeline as JaxStageTimeline  # noqa: E402,E501
from repro.launch.pipeline import flat_abstract_args as jax_abstract  # noqa: E402,E501
from repro.optim import constant as jax_constant  # noqa: E402
from repro.optim import momentum as jax_momentum  # noqa: E402
from repro_torch.core.backend import make_backend  # noqa: E402
from repro_torch.core.layerview import FlatPartition  # noqa: E402
from repro_torch.launch import pipeline as P  # noqa: E402
from repro_torch.launch.train import forward_slice_lane  # noqa: E402
from repro_torch.optim import constant, momentum  # noqa: E402

# ---------------------------------------------------------------------------
# (a) bit-exact against the port's monolithic step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["fused", "unfused"])
@pytest.mark.parametrize("M", [1, 4])
@pytest.mark.parametrize("R,D", [(1, 0), (1, 1), (2, 1)])
def test_engine_bit_exact_vs_monolithic(R, D, M, use_pallas):
    kw = dict(use_pallas=use_pallas)
    want = run_port(M, R, D, **kw)
    got = run_port(M, R, D, overlap=True, **kw)
    assert_runs_equal(got, want)
    assert got[2]["streams"] == 1.0


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["fused", "unfused"])
def test_engine_bit_exact_with_straggler_mask(use_pallas):
    kw = dict(use_pallas=use_pallas, straggler_delays=[0, 1, 2, 0])
    assert_runs_equal(run_port(4, 2, 1, overlap=True, **kw),
                      run_port(4, 2, 1, **kw))


@pytest.mark.parametrize("M", [1, 4])
def test_engine_bit_exact_int8_compensated(M):
    kw = dict(use_pallas=True, wire="int8", compensate=0.5)
    got = run_port(M, 2, 1, overlap=True, **kw)
    assert set(got[1]) == {"read", "resid", "theta"}
    assert_runs_equal(got, run_port(M, 2, 1, **kw))


def test_engine_bit_exact_with_one_step_in_flight():
    """``max_inflight_steps=1``: the host waits for each step's last fence
    before the next, numerics unchanged."""
    kw = dict(use_pallas=True)
    assert_runs_equal(run_port(4, 2, 1, overlap=True, max_inflight_steps=1,
                               **kw), run_port(4, 2, 1, **kw))


# ---------------------------------------------------------------------------
# (b) against the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("R,D", [(1, 0), (1, 1), (2, 1)])
def test_engine_matches_jax_engine_mlp(R, D):
    jloss_fn, jparams = mlp_problem()
    kw = dict(M=1, fb_ratio=R, update_delay=D, use_pallas=True,
              overlap=True)
    jbe = jax_make_backend("prod", "layup", loss_fn=jloss_fn,
                           optimizer=jax_momentum(0.9),
                           schedule=jax_constant(0.05), **kw)
    tbe = make_backend("prod", "layup", loss_fn=torch_mlp_loss,
                       optimizer=momentum(0.9), schedule=constant(0.05),
                       device="cpu", **kw)
    js = jbe.init(jax.random.PRNGKey(0), jparams)
    ts = tbe.init(None, np_tree(jparams))
    for t in range(4):
        b = np_tree(mlp_batch(t, M=1, b=8))
        js, jm = jbe.step(js, jax.tree.map(jnp.asarray, b),
                          jax.random.PRNGKey(t))
        ts, tm = tbe.step(ts, b, None)
        compare_metrics(tm, jm, t)
    compare_planes(ts["read"], js["read"], rtol=1e-5)
    assert tbe.summary()["steps"] == jbe.summary()["steps"] == 4.0


def _bench_torch_cfg():
    from benchmarks.table3_lm import _bench_cfg
    from repro_torch.configs.base import ModelConfig
    jcfg = _bench_cfg()
    kw = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    kw["dtype"] = torch.float32
    return ModelConfig(**kw)


@pytest.fixture(scope="module")
def jax_decoder_run():
    """The JAX pipeline engine on the ``_bench_cfg`` decoder (the table-3 LM
    at test size), R=2, D=1, M=1, 2 steps: params, batches, metrics and the
    final read plane as numpy."""
    from benchmarks.table3_lm import _bench_cfg
    from repro.models import build_model as jax_build_model
    from repro_torch.data.synthetic import SyntheticLM, make_worker_batches

    jmodel = jax_build_model(_bench_cfg())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jbe = jax_make_backend("prod", "layup",
                           loss_fn=lambda p, b: jmodel.loss_fn(p, b,
                                                               block_k=16),
                           optimizer=jax_momentum(0.9),
                           schedule=jax_constant(0.05), **DECODER_KW)
    ds = SyntheticLM(vocab=128, seq_len=16, temperature=1.2, seed=0)
    batches = [make_worker_batches(ds, 1, 4, t) for t in range(2)]
    js = jbe.init(jax.random.PRNGKey(0), jparams)
    metrics = []
    for t, b in enumerate(batches):
        js, jm = jbe.step(js, jax.tree.map(jnp.asarray, b),
                          jax.random.PRNGKey(t))
        metrics.append(np_tree(jm))
    return np_tree(jparams), batches, metrics, np_tree(js["read"])


DECODER_KW = dict(M=1, fb_ratio=2, update_delay=1, use_pallas=True,
                  overlap=True)


@pytest.mark.parametrize("streams", [1, 3])
def test_engine_matches_jax_engine_decoder(jax_decoder_run, streams):
    """The port's engines against the JAX pipeline engine on the decoder:
    loss and metrics rtol 1e-5, plane rtol 1e-4 (``_torch_parity.py``)."""
    from repro_torch.models import build_model

    params, batches, jmetrics, jread = jax_decoder_run
    tbe = make_backend("prod", "layup",
                       loss_fn=build_model(_bench_torch_cfg()).loss_fn,
                       optimizer=momentum(0.9), schedule=constant(0.05),
                       device="cpu", streams=streams, wait_timeout_s=20.0,
                       **DECODER_KW)
    try:
        ts = tbe.init(None, params)
        for t, b in enumerate(batches):
            ts, tm = tbe.step(ts, b, None)
            compare_metrics(tm, jmetrics[t], t)
        compare_planes(materialize(tbe, ts["read"]), jread, rtol=1e-4)
    finally:
        if streams > 1:
            tbe.engine.close()


def test_forward_slice_lane_matches_jax():
    """Each slice's loss (and slice 0's gradients) against the JAX lane's on
    the MLP fixture, R=2: rtol 1e-5 / 1e-5."""
    from repro.launch.train import forward_slice_lane as jax_slice_lane
    jloss_fn, jparams = mlp_problem()
    b = np_tree(mlp_batch(0, M=1, b=8))
    jb = {k: jnp.asarray(v[0]) for k, v in b.items()}
    tb = {k: torch.from_numpy(np.array(v[0])) for k, v in b.items()}
    tparams = {k: torch.from_numpy(np.array(v))
               for k, v in np_tree(jparams).items()}
    for r in range(2):
        jl, jg = jax_slice_lane(jloss_fn, fb_ratio=2, slice_idx=r)(jparams,
                                                                    jb)
        tl, tg = forward_slice_lane(torch_mlp_loss, fb_ratio=2,
                                    slice_idx=r)(tparams, tb)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
        assert (jg is None) == (tg is None) == (r > 0)
        if tg is not None:
            for k in tg:
                np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                           rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="slice_idx"):
        forward_slice_lane(torch_mlp_loss, fb_ratio=2, slice_idx=2)


# ---------------------------------------------------------------------------
# (c) the timeline's arithmetic against the JAX package's
# ---------------------------------------------------------------------------


class Fence:
    def __init__(self, ready=False):
        self.ready = ready

    def is_ready(self):
        return self.ready


def _fwd_gossip_counted_once(tl):
    g0 = Fence()
    tl.commit(tl.begin("gossip", 0), g0)
    f1a, f1b = Fence(), Fence()
    tl.commit(tl.begin("fwd", 1, slice_idx=0), f1a)
    tl.commit(tl.begin("fwd", 1, slice_idx=1), f1b)
    g0.ready = True
    tl.poll()
    f1a.ready = f1b.ready = True


def _no_overlap_when_ready(tl):
    g = Fence()
    tl.commit(tl.begin("gossip", 0), g)
    g.ready = True
    tl.commit(tl.begin("fwd", 1, slice_idx=0), Fence(True))


def _non_adjacent_gossip(tl):
    g, f = Fence(), Fence()
    tl.commit(tl.begin("gossip", 0), g)
    tl.commit(tl.begin("fwd", 5, slice_idx=0), f)
    g.ready = f.ready = True


def _open_event_only(tl):
    tl.commit(tl.begin("fwd", 0), Fence())


def _exec(*spans):
    def scenario(tl):
        for stage, stream, start, end, kw in spans:
            tl.record_exec(stage, 0, stream=stream, enqueue=0.0,
                           exec_start=start, complete=end, **kw)
    return scenario


TIMELINE_SCENARIOS = {
    "fwd_gossip_counted_once": _fwd_gossip_counted_once,
    "no_overlap_when_ready": _no_overlap_when_ready,
    "non_adjacent_gossip": _non_adjacent_gossip,
    "open_event_only": _open_event_only,
    "empty": lambda tl: None,
    "interleave": _exec(("fwd", "fwd", 0.0, 10.0, {}),
                        ("gossip", "gossip", 4.0, 8.0, {"group": "l1"})),
    "disjoint": _exec(("fwd", "fwd", 0.0, 5.0, {}),
                      ("gossip", "gossip", 5.0, 9.0, {})),
    "same_stream": _exec(("gossip", "gossip", 0.0, 6.0, {"group": "l1"}),
                         ("gossip", "gossip", 3.0, 9.0, {"group": "l2"})),
    "three_streams": _exec(("fwd", "a", 0.0, 6.0, {}),
                           ("update", "b", 2.0, 6.0, {}),
                           ("gossip", "c", 4.0, 6.0, {})),
    "signal_wait": _exec(("fwd", "fwd", 1.0, 2.0, {"wait_s": 1.0}),
                         ("gossip", "gossip", 2.5, 3.0, {"wait_s": 2.5})),
    "touching": _exec(("fwd", "a", 0.0, 2.0, {}), ("fwd", "b", 2.0, 4.0, {}),
                      ("fwd", "c", 4.0, 6.0, {})),
    "zero_width": _exec(("update", "a", 5.0, 5.0, {}),
                        ("gossip", "b", 5.0, 5.0, {})),
}


@pytest.mark.parametrize("name", sorted(TIMELINE_SCENARIOS))
def test_timeline_summary_matches_jax(name):
    """One scenario, one synthetic clock each: the summaries are equal
    dicts, and finalize leaves both timelines with the same events."""
    out = []
    for cls in (JaxStageTimeline, P.StageTimeline):
        clk = itertools.count()
        tl = cls(clock=lambda: float(next(clk)))
        TIMELINE_SCENARIOS[name](tl)
        before = tl.summary()  # the open events of "open_event_only"
        tl.finalize()
        out.append((before, tl.summary(), tl.events))
    assert out[0][0] == out[1][0]
    assert out[0][1] == out[1][1]
    assert out[0][2] == out[1][2]


def test_timeline_dump_is_json(tmp_path):
    _, _, _, be = run_port(1, 1, 0, steps=2, overlap=True)
    be.timeline.finalize()
    with open(be.timeline.dump(str(tmp_path / "stages.json"))) as f:
        doc = json.load(f)
    assert doc["summary"]["steps"] == 2
    assert doc["events"][0]["dispatch"] == 0.0


# ---------------------------------------------------------------------------
# (d) mechanics
# ---------------------------------------------------------------------------


def test_timeline_records_all_stages():
    _, _, _, be = run_port(1, 2, 1, steps=3, overlap=True)
    events = be.timeline.events
    assert {e["stage"] for e in events} == {"fwd", "update", "gossip"}
    assert sum(1 for e in events
               if e["stage"] == "fwd" and e["step"] == 1) == 2
    for e in events:
        assert e["complete"] is not None and e["complete"] >= e["dispatch"]
    s = be.timeline.summary()
    assert s["steps"] == 3 and set(s["stage_s"]) == {"fwd", "update",
                                                      "gossip"}


class _Pending:
    """A fence that becomes ready when the engine is told so, as a CUDA
    event does when the card gets there."""
    released = False

    def query(self):
        return _Pending.released

    def synchronize(self):
        _Pending.released = True


def test_graveyard_bounded_by_backpressure(monkeypatch):
    """With fences that stay pending, the engine holds at most
    ``max_inflight_steps`` steps and then blocks on the oldest one; once
    the fences are ready the next step prunes them all."""
    monkeypatch.setattr(P, "record_fence", lambda device: _Pending())
    _Pending.released = False
    be = make_backend("prod", "layup", M=1, loss_fn=torch_mlp_loss,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      fb_ratio=2, update_delay=1, overlap=True,
                      max_inflight_steps=2, device="cpu")
    st = be.init(None, mlp_params())
    for t in range(2):
        st, _ = be.step(st, np_tree(mlp_batch(t, M=1, b=8)))
        assert len(be.engine._graveyard) == t + 1
    assert not _Pending.released
    st, _ = be.step(st, np_tree(mlp_batch(2, M=1, b=8)))
    assert _Pending.released  # the third step blocked on the oldest fence
    assert len(be.engine._graveyard) == 1
    assert be.engine._graveyard[0][1] is None  # one stream holds nothing


@pytest.mark.parametrize("streams", [1, 2])
def test_summary_keys_match_jax(streams):
    jloss_fn, jparams = mlp_problem()
    kw = dict(M=1, overlap=True, streams=streams)
    jbe = jax_make_backend("prod", "layup", loss_fn=jloss_fn,
                           optimizer=jax_momentum(0.9),
                           schedule=jax_constant(0.05), **kw)
    js = jbe.init(jax.random.PRNGKey(0), jparams)
    js, _ = jbe.step(js, mlp_batch(0, M=1, b=8), jax.random.PRNGKey(1))
    want = jbe.summary()
    if streams > 1:
        jbe.engine.close()
    got = run_port(1, 1, 0, steps=1, overlap=True, streams=streams)[2]
    assert sorted(got) == sorted(want)
    assert got["streams"] == want["streams"] == float(streams)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("wire,compensate,D",
                         [("param", 0.0, 0), ("int8", 0.5, 1)])
def test_abstract_args_match_jax(fused, wire, compensate, D):
    """Plane, optimizer, FIFO and per-group signatures against the JAX
    package's ``flat_abstract_args`` (the port's argument lists differ:
    None where JAX drops an argument)."""
    _, jparams = mlp_problem()
    M, R = 4, 2
    kw = dict(fused=fused, wire=wire, compensate=compensate, groups=True)
    want = jax_abstract(JaxFlatPartition(jparams), jax_momentum(0.9), M, R,
                        D, **kw)
    part = FlatPartition({k: torch.from_numpy(np.array(v))
                          for k, v in mlp_params().items()})
    got = P.flat_abstract_args(part, momentum(0.9), M, R, D, **kw)
    shape = lambda s: (tuple(s.shape), s.dtype.name)  # noqa: E731
    mine = lambda s: (s[0], str(s[1]).replace("torch.", ""))  # noqa: E731
    ju, tu = want["update"], got["update"]
    assert jax.tree.map(shape, ju[0]) == {k: mine(v) for k, v in tu[0].items()}
    assert jax.tree.map(shape, ju[1]) == {k: mine(v) for k, v in tu[1].items()}
    if D:
        assert {k: mine(v) for k, v in tu[2]["g"].items()} == \
            jax.tree.map(shape, ju[2])
        assert mine(tu[2]["stamp"]) == shape(ju[3])
    assert (tu[4] is not None) == (compensate > 0)
    for g in part.group_sizes:
        jm, tm = want[f"mix:{g}"], got[f"mix:{g}"]
        assert mine(tm[0]) == shape(jm[0])
        assert (tm[1] is not None) and mine(tm[1]) == shape(
            jm[1] if fused else jm[0])
        assert (tm[2] is not None) == (wire == "int8")
    assert mine(got["clock"][0]) == shape(want["clock"][0])
    assert mine(got["clock"][1]) == shape(want["clock"][1])


def test_stage_cutouts_after_first_step():
    be = make_backend("prod", "layup", M=2, loss_fn=torch_mlp_loss,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      fb_ratio=2, update_delay=1, use_pallas=True,
                      overlap=True, device="cpu")
    st = be.init(None, mlp_params())
    with pytest.raises(ValueError, match="step the engine once"):
        be.engine.stage_cutouts()
    st, _ = be.step(st, np_tree(mlp_batch(0, M=2, b=8)))
    cut = be.engine.stage_cutouts()
    assert sorted(cut) == ["fwd0", "fwd1", "gossip", "update"]
    fn, args = cut["fwd0"]
    assert args[1] == {"labels": ((2, 8), torch.int32),
                       "x": ((2, 8, 16), torch.float32)}
    # a cutout runs on inputs made from its signature
    read = {k: torch.zeros(s, dtype=d) for k, (s, d) in args[0].items()}
    batch = {k: torch.zeros(s, dtype=d) for k, (s, d) in args[1].items()}
    losses, grads = fn(read, batch)
    assert len(losses) == 2 and set(grads) == set(read)
    with pytest.raises(NotImplementedError, match="item 15"):
        be.engine.lower()


def test_pipeline_step_wraps_the_engine():
    """``PipelineStep``: the engine behind the monolithic step's signature;
    ``lower`` names the item that has the XLA notion."""
    from repro_torch.convert import to_torch

    be = make_backend("prod", "layup", M=2, loss_fn=torch_mlp_loss,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      overlap=True, device="cpu")
    st = be.init(None, mlp_params())
    ps = P.PipelineStep(be.engine, init_state=lambda p: st,
                        describe=be.engine.describe)
    st, m = ps.fn(st, to_torch(np_tree(mlp_batch(0, M=2, b=8)), "cpu"), 0, 0)
    assert np.isfinite(float(m["loss"])) and ps.timeline is be.timeline
    assert "pipeline backend (M=2" in ps.describe
    with pytest.raises(NotImplementedError, match="item 15"):
        ps.lower()


# ids as they were before the item-10 (membership) and item-11
# (publisher) cases left
@pytest.mark.parametrize("kw,item", [
    pytest.param(dict(flat=False), "item 15", id="kw2-item 15")])
def test_unported_engine_options_name_their_roadmap_item(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        P.make_pipeline_backend_trainer(torch_mlp_loss, momentum(0.9),
                                        constant(0.05), 2, device="cpu",
                                        **kw)
    with pytest.raises(NotImplementedError, match="item 15"):
        P.make_layup_decoupled_pipeline()


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_backend("prod", "layup", M=1, loss_fn=torch_mlp_loss,
                     optimizer=momentum(0.9), schedule=constant(0.05),
                     overlap=True)


def test_reinit_resets_timeline():
    _, _, _, be = run_port(1, 1, 0, steps=2, overlap=True)
    assert be.timeline.events
    be.init(None, mlp_params())
    assert be.timeline.events == [] and be.engine._graveyard == []
