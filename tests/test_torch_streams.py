"""The port's stream engine (``streams > 1``) and its signal board.

* ``SignalBoard``: version-exact payloads, monotone signals, bounded
  retention, reset, poison, and ``take`` (the port's one-consumer read).
* ``streams ∈ {2, 3}`` (and 4: forward slices on two streams) bit-exact
  against ``streams=1`` and the monolithic step on the MLP fixture at
  (R, D) ∈ {(1, 1), (2, 1)}, M=4, fused and unfused, with the int8 wire
  and λ=0.5; 40 steps with the interpreter switching threads every
  microsecond, as a check of the coordination; the port's stream engine
  against the JAX package's at M=1 (``_torch_parity.py``'s tolerances).
* Mechanics: execution events per stream and group, ``export_params``
  materializes the futures, a re-init resets board and timeline, a stage
  that raises fails the run without a hang, the guards.

Every engine is closed in ``finally`` (``run_port`` does it), and every wait
has a timeout of 20 s at most.
"""
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _fixtures import mlp_batch, mlp_problem  # noqa: E402
from _torch_parity import (assert_runs_equal, compare_metrics,  # noqa: E402,E501
                           compare_planes, mlp_params, np_tree, run_port,
                           torch_mlp_loss)
from repro.core.backend import make_backend as jax_make_backend  # noqa: E402
from repro.launch.streams import SignalBoard as JaxSignalBoard  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro.optim import momentum as jax_momentum  # noqa: E402
from repro_torch.core.backend import make_backend  # noqa: E402
from repro_torch.launch.streams import (SignalBoard, StreamTask,  # noqa: E402
                                        TaskOutput, resolve_refs)
from repro_torch.optim import constant, momentum  # noqa: E402


# ---------------------------------------------------------------------------
# the signal board, against the JAX package's where both have the call
# ---------------------------------------------------------------------------


@pytest.fixture(params=[SignalBoard, JaxSignalBoard], ids=["port", "jax"])
def board_cls(request):
    return request.param


def test_wait_returns_version_exact_payload(board_cls):
    b = board_cls()
    b.put_signal("plane:g", 3, "v3")
    b.put_signal("plane:g", 4, "v4")
    assert b.wait_until("plane:g", 3) == "v3"
    assert b.wait_until("plane:g", 4) == "v4"
    assert b.read("plane:g") == 4


def test_signals_are_monotone(board_cls):
    b = board_cls()
    b.put_signal("s", 5)
    with pytest.raises(ValueError, match="monotone"):
        b.put_signal("s", 4)


def test_wait_timeout_raises_not_hangs(board_cls):
    with pytest.raises(TimeoutError, match="signal_wait_until"):
        board_cls().wait_until("never", 1, timeout=0.05)


def test_retention_window_eviction(board_cls):
    b = board_cls(keep=2)
    for v in range(5):
        b.put_signal("s", v, f"v{v}")
    assert b.wait_until("s", 4) == "v4"
    assert b.wait_until("s", 3) == "v3"
    with pytest.raises(KeyError, match="evicted"):
        b.wait_until("s", 1)


def test_reset_clears_slots(board_cls):
    b = board_cls()
    b.put_signal("s", 9, "x")
    b.reset()
    assert b.read("s") is None
    b.put_signal("s", 0, "fresh")
    assert b.wait_until("s", 0) == "fresh"


def test_poison_wakes_waiters(board_cls):
    b = board_cls()
    got = []

    def waiter():
        try:
            b.wait_until("s", 1, timeout=10.0)
        except RuntimeError as e:
            got.append(e)

    th = threading.Thread(target=waiter)
    th.start()
    b.poison(ValueError("stage failed"))
    th.join(timeout=10.0)
    assert not th.is_alive()
    assert len(got) == 1 and isinstance(got[0].__cause__, ValueError)


def test_take_drops_the_payload():
    b = SignalBoard()
    b.put_signal("upd:g", 0, "delta0")
    b.put_signal("upd:g", 1, "delta1")
    assert b.take("upd:g", 0, timeout=1.0) == "delta0"
    with pytest.raises(KeyError, match="evicted"):
        b.wait_until("upd:g", 0, timeout=1.0)
    assert b.wait_until("upd:g", 1, timeout=1.0) == "delta1"


def test_task_output_resolves_on_the_cpu():
    task = StreamTask("x", 0, run_fn=lambda: None, timeout=1.0)
    task._result = (torch.tensor(2.5), {"a": torch.ones(2)})
    task._done.set()
    assert float(TaskOutput(task, lambda r: r[0])) == 2.5
    tree = resolve_refs({"k": [TaskOutput(task, lambda r: r[1]["a"]), 3]})
    assert torch.equal(tree["k"][0], torch.ones(2)) and tree["k"][1] == 3
    late = StreamTask("y", 1, timeout=0.05)
    with pytest.raises(TimeoutError, match="y@1"):
        TaskOutput(late).result()


# ---------------------------------------------------------------------------
# bit-exact against streams=1 and the monolithic step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["fused", "unfused"])
@pytest.mark.parametrize("streams", [2, 3])
@pytest.mark.parametrize("R,D", [(1, 1), (2, 1)])
def test_streams_bit_exact_vs_single_stream(R, D, streams, use_pallas):
    kw = dict(use_pallas=use_pallas)
    base = run_port(4, R, D, overlap=True, **kw)
    got = run_port(4, R, D, overlap=True, streams=streams, **kw)
    assert_runs_equal(got, base)
    assert_runs_equal(got, run_port(4, R, D, **kw))
    assert got[2]["streams"] == float(min(streams, R + 2))


@pytest.mark.parametrize("streams", [2, 3])
def test_streams_bit_exact_int8_compensated(streams):
    kw = dict(use_pallas=True, wire="int8", compensate=0.5)
    got = run_port(4, 2, 1, overlap=True, streams=streams, **kw)
    assert set(got[1]) == {"read", "resid", "theta"}
    assert_runs_equal(got, run_port(4, 2, 1, overlap=True, **kw))


def test_streams_bit_exact_with_straggler_mask():
    kw = dict(use_pallas=True, straggler_delays=[0, 1, 2, 0])
    assert_runs_equal(run_port(4, 2, 1, overlap=True, streams=3, **kw),
                      run_port(4, 2, 1, **kw))


def test_four_streams_split_the_forward_slices():
    """streams=4 at R=2: the two slices on two fwd streams, so the mix of
    step t must wait for step t−1's slice 1 on the other stream."""
    got = run_port(4, 2, 1, overlap=True, streams=4, use_pallas=True)
    assert_runs_equal(got, run_port(4, 2, 1, use_pallas=True))
    assert got[2]["streams"] == 4.0


def test_many_steps_under_fast_thread_switching():
    """40 steps with the interpreter switching threads every microsecond:
    a missing wait or a lost signal shows as a different bit (or a
    timeout), since every ordering the threads may take is meant to give
    the single-stream result."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = run_port(4, 2, 1, steps=40, overlap=True, streams=4,
                       use_pallas=True)
    finally:
        sys.setswitchinterval(old)
    assert_runs_equal(got, run_port(4, 2, 1, steps=40, use_pallas=True))


def test_forward_slices_never_see_the_plane_change():
    """R=4, three streams, 20 steps: each forward slice checksums its
    parameters before and after its loss (held 2 ms) while the gossip
    thread mixes the same step's groups; the mix writes the other buffer of
    each ping-pong pair, so no slice may see its plane change."""
    from _torch_watch import PlaneWatch

    watch = PlaneWatch(torch_mlp_loss, hold=0.002)
    be = make_backend("prod", "layup", M=4, loss_fn=watch,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      fb_ratio=4, update_delay=1, use_pallas=True,
                      overlap=True, streams=3, device="cpu",
                      measure_drift=False, wait_timeout_s=20.0)
    try:
        st = be.init(None, mlp_params())
        for t in range(20):
            st, m = be.step(st, np_tree(mlp_batch(t, M=4, b=16)))
        float(m["loss"])
    finally:
        be.engine.close()
    assert len(watch.pairs) == 20 * 4 * 4
    assert watch.changed() == 0


def test_stream_engine_matches_jax_stream_engine():
    jloss_fn, jparams = mlp_problem()
    kw = dict(M=1, fb_ratio=2, update_delay=1, use_pallas=True,
              overlap=True, streams=3)
    jbe = jax_make_backend("prod", "layup", loss_fn=jloss_fn,
                           optimizer=jax_momentum(0.9),
                           schedule=jax_constant(0.05), **kw)
    tbe = make_backend("prod", "layup", loss_fn=torch_mlp_loss,
                       optimizer=momentum(0.9), schedule=constant(0.05),
                       device="cpu", wait_timeout_s=20.0, **kw)
    try:
        js = jbe.init(jax.random.PRNGKey(0), jparams)
        ts = tbe.init(None, np_tree(jparams))
        for t in range(4):
            b = np_tree(mlp_batch(t, M=1, b=8))
            js, jm = jbe.step(js, jax.tree.map(jnp.asarray, b), None)
            ts, tm = tbe.step(ts, b, None)
            compare_metrics(tm, jm, t)
        compare_planes(tbe.engine.materialize(ts["read"]),
                       jbe.engine.materialize(js["read"]), rtol=1e-5)
        assert tbe.summary()["streams"] == jbe.summary()["streams"] == 3.0
    finally:
        tbe.engine.close()
        jbe.engine.close()


# ---------------------------------------------------------------------------
# mechanics
# ---------------------------------------------------------------------------


def test_timeline_records_execution_events():
    _, _, s, be = run_port(1, 2, 1, steps=3, overlap=True, streams=3)
    evs = be.timeline.events
    assert {"fwd", "update", "gossip", "clock", "drift"} <= \
        {e["stage"] for e in evs}
    assert {e["stream"] for e in evs} == {"fwd", "update", "gossip"}
    groups = {e.get("group") for e in evs if e["stage"] == "gossip"}
    assert groups == set(be.part.group_sizes)
    for e in evs:
        assert e["complete"] >= e["exec_start"] >= e["enqueue"]
        assert e["wait_s"] >= 0.0
    assert s["streams"] == 3.0 and s["signal_wait_s"] >= 0.0
    assert s["exec_overlap_s"] >= 0.0


def test_export_params_materializes_futures():
    be = make_backend("prod", "layup", M=2, loss_fn=torch_mlp_loss,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      overlap=True, streams=2, device="cpu",
                      wait_timeout_s=20.0)
    try:
        st = be.init(None, mlp_params())
        st, _ = be.step(st, np_tree(mlp_batch(0, M=2, b=4)))
        assert isinstance(st["read"]["l1"], TaskOutput)
        tree = be.export_params(st)
        assert tuple(tree["l1"].shape) == (2, 16, 32)
        assert tuple(tree["l2"].shape) == (2, 32, 10)
    finally:
        be.engine.close()


def test_reinit_resets_board_and_timeline():
    be = make_backend("prod", "layup", M=2, loss_fn=torch_mlp_loss,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      overlap=True, streams=2, use_pallas=True, device="cpu",
                      wait_timeout_s=20.0)
    params = mlp_params()
    try:
        st = be.init(None, params)
        st, m1 = be.step(st, np_tree(mlp_batch(0, M=2, b=4)))
        first = float(m1["loss"])
        st = be.init(None, params)  # fresh measured run
        assert be.timeline.events == []
        assert be.engine.board.read("plane:l1") is None
        st, m2 = be.step(st, np_tree(mlp_batch(0, M=2, b=4)))
        assert float(m2["loss"]) == first
    finally:
        be.engine.close()


def test_failing_stage_fails_the_run_without_a_hang():
    """A loss that raises at step 2 on the fwd stream: the step's metrics
    raise it, the board is poisoned so the other streams stop waiting, and
    ``close`` returns."""
    calls = {"n": 0}

    def loss_fn(p, b):
        calls["n"] += 1
        if calls["n"] > 4:  # R=2 slices a step, M=1
            raise FloatingPointError("boom")
        return torch_mlp_loss(p, b)

    be = make_backend("prod", "layup", M=1, loss_fn=loss_fn,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      fb_ratio=2, update_delay=1, overlap=True, streams=3,
                      device="cpu", wait_timeout_s=10.0)
    st = be.init(None, mlp_params())
    try:
        for t in range(3):
            st, m = be.step(st, np_tree(mlp_batch(t, M=1, b=8)))
        with pytest.raises(FloatingPointError, match="boom"):
            float(m["loss"])
        with pytest.raises(FloatingPointError, match="boom"):
            be.engine.finalize()  # drains every task, then re-raises
    finally:
        be.engine.close()
    assert all(not s._thread.is_alive() for s in be.engine._streams)


def test_streams_need_two():
    from repro_torch.launch.streams import StreamEngine
    with pytest.raises(ValueError, match=">= 2 streams"):
        StreamEngine(R=1, D=0, M=1, group_names=["a"], stages={},
                     group_stages={}, device="cpu", n_streams=1)


@pytest.mark.parametrize("streams", [1, 3])
def test_engine_run_leaves_no_cyclic_garbage(streams):
    """With the cyclic collector off, a run's planes are freed as soon as
    the run's references go: no task, closure or frame keeps them in a
    reference cycle (on the card such a cycle holds GBs until a collection
    happens to run)."""
    import gc
    import weakref

    gc.collect()
    gc.disable()
    try:
        be = make_backend("prod", "layup", M=4, loss_fn=torch_mlp_loss,
                          optimizer=momentum(0.9), schedule=constant(0.05),
                          fb_ratio=2, update_delay=1, use_pallas=True,
                          overlap=True, streams=streams, device="cpu",
                          wait_timeout_s=20.0)
        st = be.init(None, mlp_params())
        refs = [weakref.ref(v) for name in ("read", "write", "opt")
                for v in st[name].values()]
        for t in range(3):
            st, m = be.step(st, np_tree(mlp_batch(t, M=4, b=8)))
        float(m["loss"])
        if streams > 1:
            be.engine.close()
        del st, m, be
        assert [r() is None for r in refs] == [True] * len(refs)
    finally:
        gc.enable()
