"""The port's chaos injection and membership (``repro_torch.chaos`` and the
alive-gated step) against the JAX package's ``repro.chaos``.

* Copied logic: ``FaultPlan`` (parse, order, errors), ``PeerHealth`` (the
  ladder on one seeded beat schedule, ``wait_guarded`` on the port's
  ``SignalBoard``) and ``buffer_checksum`` (float32 and bfloat16 planes
  from one numpy seed: the same CRC32 as the reference's) equal to the
  reference's.
* The controller on the same state at M=4: ``_kill``'s push-sum weights
  and mask and a recover's re-synced rows (``read``, ``write``, ``opt``,
  ``versions``, ``resid``, ``theta``, ``fifo``) and mass split, bit for bit.
* The empty plan gives the same bits as ``faults=None`` on the MLP fixture:
  (R, D) ∈ {(1,0), (1,1), (2,1)} × {monolithic, overlap, streams=2} × M ∈
  {1, 2, 3, 4} × {param, int8}.
* The degraded hop, fused and plain, both wires: a degraded row is
  ``op(x, x, u, 1, 0)``, a NaN in a dead peer's rows reaches no live row,
  Σw is conserved over the live set, and an all-alive mask gives the
  ungated bits.
* Faulted runs on the engines give the same bits as on the monolithic
  step (M=4, R=2, D=1), and the backend's counters and metrics.

Every engine is closed (``run_port`` does it); every wait times out.
"""
import dataclasses
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _fixtures import mlp_batch  # noqa: E402
from _torch_parity import (assert_runs_equal, mlp_params,  # noqa: E402
                           np_tree, run_port, torch_mlp_loss)
from repro import chaos as jchaos  # noqa: E402
from repro.chaos import recovery as jrecovery  # noqa: E402
from repro.launch.streams import SignalBoard as JaxSignalBoard  # noqa: E402
from repro_torch import chaos  # noqa: E402
from repro_torch.core.backend import make_backend  # noqa: E402
from repro_torch.kernels.ref import gossip_mix_ref  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.launch.streams import SignalBoard  # noqa: E402
from repro_torch.optim import constant, momentum  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# copied logic: FaultPlan, PeerHealth, checksums
# ---------------------------------------------------------------------------

SPECS = ["", "crash:peer=1,step=5", "crash:peer=2,step=3,recover=7",
         "crash:peer=1,step=5;nan:step=3,peer=0,group=1;hang:step=2,"
         "seconds=0.1", "corrupt:step=4,group=1;drop:step=6,group=0;"
         "recover:peer=1,step=9,donor=0", " ; crash:peer=0, step=1 ;"]
BAD = ["explode:step=1", "crash:peer=1", "crash:peer=1,step=-2",
       "nan:step=1,recover=3", "hang:step=1,seconds=99",
       "crash:step=1,frobs=2", "crash", "crash:peer"]


def _faults(plan):
    return [dataclasses.astuple(f) for f in plan.faults]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_parses_as_the_reference(spec):
    got, want = chaos.FaultPlan.parse(spec, seed=3), \
        jchaos.FaultPlan.parse(spec, seed=3)
    assert _faults(got) == _faults(want) and got.seed == want.seed
    assert got.describe() == want.describe()
    assert (got.empty, got.last_step) == (want.empty, want.last_step)
    for t in range(11):
        assert [dataclasses.astuple(f) for f in got.at(t)] == \
            [dataclasses.astuple(f) for f in want.at(t)]
    assert chaos.FaultPlan.parse(spec) == chaos.FaultPlan.parse(spec)
    assert chaos.as_plan(spec) == chaos.FaultPlan.parse(spec)
    assert chaos.as_plan(got) is got


@pytest.mark.parametrize("bad", BAD)
def test_fault_plan_rejects_as_the_reference(bad):
    with pytest.raises(ValueError) as got:
        chaos.FaultPlan.parse(bad)
    with pytest.raises(ValueError) as want:
        jchaos.FaultPlan.parse(bad)
    assert str(got.value) == str(want.value)


def test_as_plan_types():
    assert chaos.as_plan(None) == chaos.FaultPlan()
    with pytest.raises(TypeError):
        chaos.as_plan(3)


def _health_trace(mod, M, schedule, readmits):
    """Drive a PeerHealth through one beat schedule; record every view."""
    h = mod.PeerHealth(M, suspect_after=1, dead_after=3)
    out = []
    for t, beats in enumerate(schedule):
        for p in beats:
            h.beat(p, t)
        if t in readmits:
            h.readmit(readmits[t], t)
        trans = h.observe(t)
        out.append((trans, [h.status(p) for p in range(M)],
                    h.alive_mask().tobytes(), h.peers_dead, h.peers_suspect,
                    [h.is_live(p) for p in range(M)],
                    [h.serving_ok(p) for p in range(M)]))
    out.append(([h.detect_latency(p) for p in range(M)], h.events))
    return out


def test_peer_health_ladder_matches_reference():
    rng = np.random.default_rng(0)
    M = 4
    schedule = [[p for p in range(M) if rng.random() < 0.6]
                for _ in range(30)]
    readmits = {12: 1, 20: 2, 25: 0}
    got = _health_trace(chaos.health, M, schedule, readmits)
    want = _health_trace(jchaos.health, M, schedule, readmits)
    assert got == want
    assert got[-1][1], "the schedule made no transition"


def test_peer_health_rejects_bad_thresholds():
    with pytest.raises(ValueError):
        chaos.PeerHealth(2, suspect_after=2, dead_after=2)


def test_wait_guarded_on_the_ports_board():
    for mod, Board in ((chaos.health, SignalBoard),
                       (jchaos.health, JaxSignalBoard)):
        h = mod.PeerHealth(2)
        board = Board()
        board.put_signal("x", 3, "payload")
        assert h.wait_guarded(board, "x", 3, peer=1,
                              deadline=0.05) == "payload"
        t0 = time.monotonic()
        assert h.wait_guarded(board, "never", 1, peer=1, epoch=7,
                              deadline=0.01, retries=2) is None
        assert time.monotonic() - t0 < 2.0
        assert h.status(1) == mod.DEAD
        assert (7, 1, mod.SUSPECT, mod.DEAD) in h.events


def test_wait_guarded_late_signal_while_suspect():
    import threading

    h = chaos.PeerHealth(2)
    board = SignalBoard()
    thr = threading.Thread(
        target=lambda: (time.sleep(0.1), board.put_signal("late", 1, "ok")))
    thr.start()
    out = h.wait_guarded(board, "late", 1, peer=0, deadline=0.02, retries=3)
    thr.join()
    assert out == "ok" and h.peers_dead == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_buffer_checksum_equals_reference(dtype):
    rng = np.random.default_rng(5)
    vals = rng.standard_normal((4, 1000)).astype(np.float32)
    t = torch.from_numpy(vals).to(getattr(torch, dtype))
    j = jnp.asarray(vals, getattr(jnp, dtype))
    assert chaos.buffer_checksum(t) == jchaos.buffer_checksum(j)
    # a strided view checksums its values, as a copy of them does
    assert chaos.buffer_checksum(t[:, ::2]) == \
        jchaos.buffer_checksum(j[:, ::2])
    plane = {"a": t, "b": t[1:]}
    assert chaos.plane_checksum(plane) == jchaos.plane_checksum(
        {"a": j, "b": j[1:]})


@pytest.mark.parametrize("kind", ["corrupt", "drop", "clean"])
def test_wire_guard_round_trip_as_reference(kind):
    rng = np.random.default_rng(1)
    vals = {"l1": rng.standard_normal((2, 16)).astype(np.float32),
            "l2": rng.standard_normal((2, 8)).astype(np.float32)}
    plane = {k: torch.from_numpy(v) for k, v in vals.items()}
    kw = {"corrupt": dict(corrupt_group="l1"), "drop": dict(drop_group="l2"),
          "clean": {}}[kind]
    g, jg = chaos.WireGuard(), jchaos.WireGuard()
    delivered, events = g.round_trip(plane, **kw)
    _, jevents = jg.round_trip({k: jnp.asarray(v) for k, v in vals.items()},
                               **kw)
    assert events == jevents and g.counters() == jg.counters()
    for k in plane:  # repair == resend: the very buffers
        assert delivered[k] is plane[k]
        np.testing.assert_array_equal(plane[k].numpy(), vals[k])


# ---------------------------------------------------------------------------
# the controller against the reference, on the same state
# ---------------------------------------------------------------------------


def _np_state(M=4, D=1, seed=0):
    rng = np.random.default_rng(seed)

    def plane(scale=1.0):
        return {"g0": (rng.standard_normal((M, 12)) * scale).astype(
                    np.float32),
                "g1": (rng.standard_normal((M, 7)) * scale).astype(
                    np.float32)}
    w = rng.random(M).astype(np.float32) + 0.1
    return {"read": plane(), "write": plane(),
            "opt": {"mu": plane(0.1), "count": np.zeros((), np.int32)},
            "w": (w / w.sum()).astype(np.float32),
            "versions": rng.random((M, 2)).astype(np.float32),
            "resid": plane(0.01), "theta": plane(),
            "fifo": {"g": {k: v[:, None].repeat(D, 1)
                           for k, v in plane().items()},
                     "stamp": np.arange(D, dtype=np.float32)},
            "alive": np.ones(M, np.float32)}


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    return fn(tree)


def _host(tree):
    return _to(tree, lambda v: np.asarray(v.numpy() if isinstance(
        v, torch.Tensor) else v))


def _assert_bits(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_bits(got[k], want[k], f"{path}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, path
    assert g.tobytes() == w.tobytes(), path


@pytest.mark.parametrize("spec,damp", [
    ("crash:peer=1,step=2", 0.0),
    ("crash:peer=1,step=2,recover=6", 0.0),
    ("crash:peer=2,step=1,recover=5;recover:peer=2,step=7,donor=3", 0.5),
    ("crash:peer=0,step=1;crash:peer=3,step=2,recover=6", 0.5)])
def test_controller_matches_reference_state(spec, damp):
    """``before_step`` over 9 steps on one state at M=4: the reference on
    jax arrays, the port on CPU tensors (its mask on the host); every state
    leaf bit-equal after every step, and the same summary."""
    base = _np_state()
    jstate = _to(base, jnp.asarray)
    tstate = _to({k: v for k, v in base.items() if k != "alive"},
                 lambda v: torch.from_numpy(np.array(v)))
    tstate["alive"] = base["alive"].copy()
    jc = jchaos.ChaosController(spec, 4, update_delay=1, compensate=damp)
    tc = chaos.ChaosController(spec, 4, update_delay=1, compensate=damp)
    for t in range(9):
        jstate, _ = jc.before_step(jstate, None, t)
        tstate, _ = tc.before_step(tstate, None, t)
        _assert_bits(_host(tstate), _host(jstate), f"step {t}")
    assert tc.summary() == jc.summary()
    if "recover" in spec:
        assert tc.resyncs >= 1 and tc.event_s["resync"]
    assert tc.event_s["kill"]


@pytest.mark.parametrize("damp", [1.0, 0.5])
def test_resync_peer_matches_reference(damp):
    base = _np_state(D=2, seed=3)
    base["w"][1] = 0.0  # the peer is dead: its mass went to the survivors
    want = jrecovery.resync_peer(_to(base, jnp.asarray), 1, 3, 4, damp=damp)
    tstate = _to(base, lambda v: torch.from_numpy(np.array(v)))
    got = chaos.resync_peer(tstate, 1, 3, 4, damp=damp)
    _assert_bits(_host(got), _host(want))
    for key in ("read", "write", "theta", "resid"):  # rows copied in place
        for g in base[key]:
            assert torch.equal(tstate[key][g][1], tstate[key][g][3])
    w0, w1 = base["w"], got["w"].numpy()
    # Σw is unchanged: the donor's mass is split in two; with damp 1 the
    # two terms re-add to it bit for bit
    if damp == 1.0:
        assert np.float32(w1[1] + w1[3]) == w0[3]
    np.testing.assert_allclose(w1.sum(dtype=np.float64),
                               w0.sum(dtype=np.float64), rtol=1e-7)
    with pytest.raises(ValueError):
        chaos.resync_peer(tstate, 1, 1, 4)
    with pytest.raises(ValueError):
        chaos.resync_peer(tstate, 1, 0, 4, damp=0.0)


def test_nan_fault_poisons_fifo_and_float_batch_leaves():
    base = _np_state(D=1)
    tstate = _to({k: v for k, v in base.items() if k != "alive"},
                 lambda v: torch.from_numpy(np.array(v)))
    jstate = _to({k: v for k, v in base.items() if k != "alive"},
                 jnp.asarray)
    spec = "nan:step=0,peer=2,group=1"
    got, _ = chaos.ChaosController(spec, 4, update_delay=1).before_step(
        tstate, None, 0)
    want, _ = jchaos.ChaosController(spec, 4, update_delay=1).before_step(
        jstate, None, 0)
    _assert_bits(_host(got), _host(want))
    assert bool(torch.isnan(got["fifo"]["g"]["g1"][2, 0]).all())
    # D == 0: the batch's float rows, never its integer tokens
    batch = {"x": np.ones((4, 3), np.float32),
             "tokens": np.arange(12, dtype=np.int32).reshape(4, 3),
             "t": torch.ones(4, 3)}
    _, out = chaos.ChaosController(spec, 4).before_step({}, batch, 0)
    assert np.isnan(out["x"][2]).all() and not np.isnan(out["x"][:2]).any()
    assert out["tokens"] is batch["tokens"]
    assert bool(torch.isnan(out["t"][2]).all())
    assert not np.isnan(batch["x"]).any()  # the caller's batch untouched


def test_wire_fault_repairs_bit_exact_with_counters():
    plane = {"l1": torch.ones(2, 8), "l2": torch.full((2, 4), 2.0,
                                                      dtype=torch.bfloat16)}
    ctl = chaos.ChaosController("corrupt:step=1,group=0;drop:step=2,group=1",
                                M=2)
    state = {"read": dict(plane)}
    for t in (0, 1, 2):
        state, _ = ctl.before_step(state, None, t)
    for name in plane:
        assert state["read"][name] is plane[name]
    s = ctl.summary()
    assert (s["checksum_rejects"], s["drops_detected"], s["resends"],
            s["rounds_degraded"]) == (1, 1, 2, 2)
    assert len(ctl.event_s["guard_round"]) == 2


def test_empty_plan_never_touches_state():
    ctl = chaos.ChaosController("", M=2, update_delay=1)
    state = {"w": torch.ones(2) / 2}
    out_state, out_batch = ctl.before_step(state, {"x": 1}, 0)
    assert out_state is state and out_batch == {"x": 1}
    assert ctl.summary()["rounds_degraded"] == 0


def test_liveness_beats_land_on_the_board():
    board = SignalBoard()
    ctl = chaos.ChaosController("crash:peer=1,step=1", M=3)
    ctl.attach(board=board)
    for t in range(3):
        ctl.before_step({"w": torch.ones(3) / 3,
                         "alive": np.ones(3, np.float32)}, None, t)
    assert [board.read(f"live:{p}") for p in range(3)] == [2, 0, 2]
    board.reset()
    ctl.before_step({"w": torch.ones(3) / 3}, None, 1)  # a stale put: no raise


# ---------------------------------------------------------------------------
# the empty plan: the same bits as faults=None
# ---------------------------------------------------------------------------

ENGINES = {"monolithic": {}, "overlap": {"overlap": True},
           "streams": {"overlap": True, "streams": 2}}


@pytest.mark.parametrize("wire", ["param", "int8"])
@pytest.mark.parametrize("M", [1, 2, 3, 4])
@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("R,D", [(1, 0), (1, 1), (2, 1)])
def test_empty_plan_bit_exact(R, D, engine, M, wire):
    kw = dict(use_pallas=True, wire=wire, **ENGINES[engine])
    want = run_port(M, R, D, steps=4, **kw)
    got = run_port(M, R, D, steps=4, faults="", **kw)
    assert_runs_equal(got, want)
    s = got[2]
    assert s["peers_live"] == float(M) and s["faults_injected"] == 0
    assert s["rounds_degraded"] == 0 and s["nonfinite_skips"] == 0.0


# ---------------------------------------------------------------------------
# the degraded hop
# ---------------------------------------------------------------------------


def _hop_operands(M=4, n=300, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, n)).astype(np.float32))
    u = torch.from_numpy((rng.standard_normal((M, n)) * 0.1).astype(
        np.float32))
    w = rng.random(M).astype(np.float32) + 0.2
    return x, u, torch.from_numpy(w / w.sum())


@pytest.mark.parametrize("wire", ["param", "int8"])
@pytest.mark.parametrize("route", ["fused", "fused_ops", "plain"])
@pytest.mark.parametrize("shift_idx", [0, 1])
def test_degraded_hop(route, wire, shift_idx):
    """Peer 2 is dead and its rows hold NaN. Rows whose source or self is
    dead are degraded: on the fused route they apply their own update and
    mix nothing in (``op(x, x, u, 1, 0)``; on the int8 wire the same
    values), on the plain route they keep their buffer. No live row reads a
    NaN, the dead peer's weight is 0 and Σw is conserved over the live set;
    an all-alive mask gives the ungated bits."""
    M, shifts = 4, (1, 2)
    s = shifts[shift_idx]
    x, u, w = _hop_operands(M)
    dead = 2
    x[dead] = float("nan")
    alive = torch.tensor([1.0, 1.0, 0.0, 1.0])
    use = [(alive[(i - s) % M] * alive[i]) > 0 for i in range(M)]
    # the dead peer's mass went to the survivors (the controller's renorm)
    w[dead] = 0.0
    w = w / w.sum()
    int8 = wire == "int8"
    if route == "plain":
        lane = T.gossip_plane_lane(None, M, shifts, wire=wire)

        def run(x, al):
            u_, plane = u.clone(), {"g": x.clone()}
            plane["g"].add_(torch.where(alive[:, None] > 0, u_,
                                        torch.zeros_like(u_)))
            before = plane["g"].clone()
            kw = {} if al is None else {"alive": al}
            if int8:
                out, _, nw = lane(plane, {"g": torch.zeros_like(x)}, w,
                                  shift_idx, **kw)
            else:
                out, nw = lane(plane, w, shift_idx, **kw)
            return out["g"], nw, before
    else:
        lane = T.gossip_fused_lane(None, M, shifts, wire=wire,
                                   use_pallas=route == "fused_ops")

        def run(x, al):
            plane = {"g": x.clone()}
            upd = {"g": u.clone()}
            if al is not None:
                T.gate_update(upd, None, al)
            before = plane["g"].clone()
            kw = {} if al is None else {"alive": al}
            if int8:
                out, _, nw = lane(plane, {"g": torch.zeros_like(x)}, upd, w,
                                  shift_idx, **kw)
            else:
                out, nw = lane(plane, upd, w, shift_idx, **kw)
            return out["g"], nw, (before, upd["g"])

    out, new_w, before = run(x, alive)
    for i in range(M):
        if use[i]:
            assert bool(torch.isfinite(out[i]).all()), i
            continue
        if route == "plain":
            want = before[i]
        else:
            xi, ui = before[0][i:i + 1], before[1][i:i + 1]
            want = gossip_mix_ref(xi, xi, ui, 1.0, 0.0)[0]
        assert torch.equal(out[i], want) or (
            i == dead and bool(torch.isnan(out[i]).all())), i
    assert float(new_w[dead]) == 0.0
    live = alive > 0
    np.testing.assert_allclose(float(new_w[live].sum()), float(w[live].sum()),
                               rtol=1e-6)
    # all alive: the gated hop is the ungated one, bit for bit
    x2 = _hop_operands(M, seed=1)[0]
    a, wa, _ = run(x2, torch.ones(M))
    b, wb, _ = run(x2, None)
    assert torch.equal(a, b) and torch.equal(wa, wb)


def test_gated_step_freezes_dead_peer():
    """A dead peer's replica, clocks and weight stay put while the others
    train, and the loss is the live peers' mean."""
    be = make_backend("prod", "layup", M=4, loss_fn=torch_mlp_loss,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      fb_ratio=1, update_delay=1, use_pallas=True,
                      device="cpu", faults="crash:peer=2,step=1")
    st = be.init(None, mlp_params())
    snap = None
    for t in range(6):
        st, m = be.step(st, np_tree(mlp_batch(t, M=4, b=8)))
        if t == 2:  # dead from step 2 on (suspect at 1)
            snap = ({k: v[2].clone() for k, v in st["read"].items()},
                    st["versions"][2].clone())
            assert float(st["w"][2]) == 0.0
        assert abs(float(m["weight_sum"]) - 1.0) < 1e-6
        assert float(m["peers_live"]) == (4.0 if t < 2 else 3.0)
    for k, v in st["read"].items():
        assert torch.equal(v[2], snap[0][k]), k
        assert not torch.equal(v[0], v[2])
    assert torch.equal(st["versions"][2], snap[1])
    assert float(st["w"][2]) == 0.0


# ---------------------------------------------------------------------------
# faulted runs: the engines against the monolithic step, and the backend
# ---------------------------------------------------------------------------

PLANS = {"crash": "crash:peer=1,step=2,recover=6",
         "mixed": "crash:peer=1,step=2,recover=6;nan:step=4,peer=0,group=0;"
                  "corrupt:step=5,group=1;hang:step=3,seconds=0.01;"
                  "drop:step=7,group=0"}


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("pallas", [True, False])
@pytest.mark.parametrize("wire", ["param", "int8"])
def test_faulted_engines_match_monolithic(wire, pallas, plan):
    kw = dict(use_pallas=pallas, wire=wire, faults=PLANS[plan],
              compensate=0.5 if plan == "mixed" else 0.0)
    want = run_port(4, 2, 1, steps=8, **kw)
    for engine in ({"overlap": True}, {"overlap": True, "streams": 2},
                   {"overlap": True, "streams": 3}):
        got = run_port(4, 2, 1, steps=8, **kw, **engine)
        assert_runs_equal(got, want)
        assert got[2]["resyncs"] == want[2]["resyncs"] == 1
        assert got[2]["nonfinite_skips"] == want[2]["nonfinite_skips"]
    for h in want[0]:
        assert np.isfinite(h["loss"]) and abs(h["weight_sum"] - 1.0) < 1e-5
    if plan == "mixed":
        assert want[2]["nonfinite_skips"] >= 1.0
        assert want[2]["checksum_rejects"] == want[2]["drops_detected"] == 1


@pytest.mark.parametrize("kw", [
    dict(), dict(overlap=True), dict(overlap=True, streams=2),
    dict(wire="int8"), dict(wire="int8", compensate=0.5, overlap=True),
    dict(compensate=0.5, overlap=True, streams=3)])
def test_faults_accepted_on_every_route(kw):
    """``faults=`` no longer raises; the counters, ``peers_live`` and the
    cumulative nonfinite skips land in ``summary()``."""
    be = make_backend("prod", "layup", M=4, loss_fn=torch_mlp_loss,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      fb_ratio=1, update_delay=1, use_pallas=True,
                      device="cpu", wait_timeout_s=20.0,
                      faults="crash:peer=3,step=1,recover=5;"
                             "nan:step=2,peer=0,group=0", **kw)
    try:
        st = be.init(None, mlp_params())
        live = []
        for t in range(7):
            st, m = be.step(st, np_tree(mlp_batch(t, M=4, b=8)))
            live.append(float(m["peers_live"]))
        s = be.summary()
    finally:
        if hasattr(be.engine, "close"):
            be.engine.close()
    assert live == [4.0, 4.0, 3.0, 3.0, 3.0, 4.0, 4.0]
    assert s["resyncs"] == 1 and s["peers_dead"] == 0
    assert s["nonfinite_skips"] >= 1.0 and s["peers_live"] == 4.0
    assert s["time_to_detect_steps"] == 2.0


def test_bad_plan_fails_in_init():
    with pytest.raises(ValueError, match="unknown fault kind"):
        make_backend("prod", "layup", M=2, loss_fn=torch_mlp_loss,
                     optimizer=momentum(0.9), schedule=constant(0.05),
                     device="cpu", faults="explode:step=1")


def test_port_imports_neither_jax_nor_the_reference():
    """The chaos package and the modules it changed import with ``jax`` and
    ``repro`` blocked, and a faulted run goes through."""
    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np
from repro_torch import chaos
from repro_torch.chaos import controller, guard, health, plan, recovery
from repro_torch.core.backend import make_backend
from repro_torch.launch import pipeline, streams, train
from repro_torch.optim import constant, sgd
import torch
def loss(p, b):
    return ((b["x"] @ p["w"]) ** 2).mean(), {}
be = make_backend("prod", "layup", M=3, loss_fn=loss, optimizer=sgd(0.1),
                  schedule=constant(0.1), device="cpu", overlap=True,
                  streams=2, wait_timeout_s=20.0,
                  faults="crash:peer=1,step=1,recover=4")
st = be.init(None, {"w": np.ones((4, 2), np.float32)})
for t in range(6):
    st, m = be.step(st, {"x": np.ones((3, 2, 4), np.float32)})
be.engine.close()
assert be.summary()["resyncs"] == 1
assert not any(k.split(".")[0] in ("jax", "repro") for k in sys.modules)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-2000:]
