"""The port's serving subsystem (``repro_torch.serving``): the cases of
``tests/test_serving_live.py`` (publisher handoff, swap gating, admission
control, live checkpoint-free swaps) and the ``SwapPolicy`` health gate of
``tests/test_chaos.py``, then against the JAX package on the same inputs:
the policy's decisions on the same snapshots, and the end-to-end live swap
(trainer with a publisher → ``LiveServer`` → ``ServeLoop``) on the
``tiny-lm`` config, both lanes.

Inside the port: a published snapshot stays as it was while training goes
on (both lanes, both routes), and a publisher does not change training by
one bit.

Tolerances: the swapped params against the JAX run's at the decoder plane
tolerance of ``_torch_parity.py`` (rtol 1e-4, atol 1e-6); decisions,
counts and snapshots exactly.
"""
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import (assert_runs_equal, compare_planes,  # noqa: E402
                           run_port, torch_cfg, torch_mlp_loss)
from repro_torch.chaos.health import PeerHealth  # noqa: E402
from repro_torch.core.backend import make_backend  # noqa: E402
from repro_torch.core.layerview import FlatPartition  # noqa: E402
from repro_torch.core.pytree import tree_leaves  # noqa: E402
from repro_torch.optim import constant, momentum  # noqa: E402
from repro_torch.serving import (AdmissionQueue, LiveServer,  # noqa: E402
                                 PlanePublisher, PlaneSnapshot, SwapPolicy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANE_TOL = dict(rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# publisher
# ---------------------------------------------------------------------------

def _tiny_tree(fill):
    return {"blocks": {"w": torch.full((2, 3, 4), fill)},
            "embed": {"table": torch.full((8, 4), fill)}}


def _publish(pub, part, fill, step, *, drift=None, M=1):
    """Pack a constant-filled tree and publish it as an (M, size) plane."""
    flat = part.pack(_tiny_tree(fill))
    plane = {g: torch.stack([b] * M) for g, b in flat.items()}
    versions = torch.full((M, part.num_groups), float(step + 1))
    return pub.publish(plane, versions, torch.ones(M), step, drift=drift)


def test_publisher_cadence_seq_and_latest():
    part = FlatPartition(_tiny_tree(0.0))
    pub = PlanePublisher(every=2)
    snaps = [_publish(pub, part, float(i), i) for i in range(5)]
    # calls 1, 3, 5 kept; calls 2, 4 skipped
    assert [s is not None for s in snaps] == [True, False, True, False, True]
    assert pub.stats.published == 3 and pub.stats.skipped == 2
    assert [s.seq for s in snaps if s] == [1, 2, 3]  # seq counts publishes
    latest = pub.latest()
    assert latest.seq == 3 and latest.step == 4
    assert pub.latest(after_seq=3) is None           # nothing newer
    assert pub.latest(after_seq=2).seq == 3
    assert pub.wait_for(after_seq=2, timeout=0.01).seq == 3
    assert pub.wait_for(after_seq=3, timeout=0.01) is None  # times out
    # on the CPU there is no CUDA event to wait on
    assert latest.event is None and latest.stream is None


def test_publisher_stable_flag_controls_copy():
    part = FlatPartition(_tiny_tree(0.0))
    pub = PlanePublisher()
    flat = part.pack(_tiny_tree(1.0))
    plane = {g: b[None] for g, b in flat.items()}
    v, w = torch.ones((1, part.num_groups)), torch.ones(1)
    s1 = pub.publish(plane, v, w, 0, stable=True)
    for g in plane:
        assert s1.plane[g] is plane[g]               # zero-copy handles
    s2 = pub.publish(plane, v, w, 1, stable=False)
    for g in plane:
        assert s2.plane[g] is not plane[g]           # stabilized copies
        assert s2.plane[g].data_ptr() != plane[g].data_ptr()
        assert torch.equal(s2.plane[g], plane[g])
    assert pub.stats.copied_planes == 1
    # version clocks and weights are copied on BOTH paths
    for s in (s1, s2):
        assert s.versions.data_ptr() != v.data_ptr()
        assert s.w.data_ptr() != w.data_ptr()


def test_publisher_rejects_bad_cadence():
    with pytest.raises(ValueError):
        PlanePublisher(every=0)


# ---------------------------------------------------------------------------
# swap policy
# ---------------------------------------------------------------------------

def _snap(seq, step, *, versions=None, drift=None, G=3):
    if versions is None:
        versions = np.full((1, G), float(step + 1), np.float32)  # staleness 0
    return PlaneSnapshot(seq=seq, step=step, plane={},
                         versions=torch.as_tensor(np.asarray(versions,
                                                             np.float32)),
                         w=torch.ones(1),
                         drift=None if drift is None else torch.tensor(drift))


def test_policy_staleness_gate():
    pol = SwapPolicy(max_staleness=2.0)
    ok = pol.evaluate(_snap(1, 10, versions=np.full((1, 3), 9.0)))   # 2.0
    assert ok.accepted and ok.reason == "fresh" and ok.staleness_max == 2.0
    bad = pol.evaluate(_snap(2, 10, versions=np.full((1, 3), 8.0)))  # 3.0
    assert not bad.accepted and bad.reason == "staleness"
    # the max over groups gates, not the mean
    mixed = np.asarray([[11.0, 11.0, 7.0]])                          # max 4.0
    assert not pol.evaluate(_snap(3, 10, versions=mixed)).accepted
    assert pol.gated_rejections == 2 and pol.accepted == 1


def test_policy_drift_gate():
    pol = SwapPolicy(max_drift=0.5)
    assert pol.evaluate(_snap(1, 0, drift=0.4)).accepted
    d = pol.evaluate(_snap(2, 0, drift=0.9))
    assert not d.accepted and d.reason == "drift"
    assert d.drift == pytest.approx(0.9)
    # unmeasured drift (None) passes the gate rather than rejecting
    assert pol.evaluate(_snap(3, 0, drift=None)).accepted
    assert pol.gated_rejections == 1


def test_policy_swap_cadence():
    pol = SwapPolicy(min_interval_steps=5, max_interval_steps=20,
                     max_staleness=0.0)
    first = pol.evaluate(_snap(1, 10), last_swap_step=None)
    assert first.accepted                       # no prior swap: no interval
    too_soon = pol.evaluate(_snap(2, 12), last_swap_step=10)
    assert not too_soon.accepted and too_soon.reason == "min-interval"
    stale = np.zeros((1, 3), np.float32)        # staleness = step+1, huge
    forced = pol.evaluate(_snap(3, 31, versions=stale), last_swap_step=10)
    assert forced.accepted and forced.reason == "forced-max-interval"
    gated = pol.evaluate(_snap(4, 25, versions=stale), last_swap_step=10)
    assert not gated.accepted and gated.reason == "staleness"
    assert pol.rejected == 2 and pol.gated_rejections == 1
    assert pol.counts == {"fresh": 1, "min-interval": 1,
                          "forced-max-interval": 1, "staleness": 1}


class _Snap:
    """A snapshot with numpy clocks and no plane (test_chaos.py's)."""

    def __init__(self, seq, step):
        self.seq, self.step = seq, step
        self.versions = np.full((1, 2), float(step), np.float32)
        self.drift = None


def test_policy_health_gate_rejects_unhealthy_source():
    h = PeerHealth(2)
    h.mark_suspect(1, 0)
    pol = SwapPolicy(health=h)
    ok = pol.evaluate(_Snap(0, 5), worker=0)
    assert ok.accepted and ok.reason == "fresh"
    bad = pol.evaluate(_Snap(1, 6), worker=1)
    assert not bad.accepted and bad.reason == "unhealthy-source"
    assert pol.counts["unhealthy-source"] == 1
    assert pol.rejected == 1


def test_policy_health_gate_beats_forced_accept():
    h = PeerHealth(2)
    h.mark_dead(1, 0)
    pol = SwapPolicy(max_interval_steps=1, health=h)
    d = pol.evaluate(_Snap(0, 100), last_swap_step=0, worker=1)
    assert not d.accepted and d.reason == "unhealthy-source"
    h.readmit(1, 1)
    d2 = pol.evaluate(_Snap(1, 101), last_swap_step=0, worker=1)
    assert d2.accepted and d2.reason == "forced-max-interval"
    # without a health view the worker is ignored
    assert SwapPolicy().evaluate(_Snap(2, 1), worker=3).accepted


POLICIES = [
    dict(),
    dict(max_staleness=1.5),
    dict(max_drift=0.3, min_interval_steps=2),
    dict(max_staleness=0.5, max_drift=0.6, min_interval_steps=1,
         max_interval_steps=4),
    dict(health="suspect"), dict(health="dead", max_interval_steps=2),
]


@pytest.mark.parametrize("kw", POLICIES, ids=str)
def test_policy_decisions_match_jax(kw):
    """The same 40 snapshots (clocks, drift, last swap, worker) through the
    port's policy and the reference's: the same decisions and counts."""
    from repro.chaos.health import PeerHealth as JPeerHealth
    from repro.serving.policy import SwapPolicy as JSwapPolicy
    from repro.serving.publisher import PlaneSnapshot as JPlaneSnapshot

    kw = dict(kw)
    health = kw.pop("health", None)
    hs = {}
    if health is not None:
        for name, cls in (("port", PeerHealth), ("jax", JPeerHealth)):
            hs[name] = cls(3)
            getattr(hs[name], f"mark_{health}")(2, 0)
    tpol = SwapPolicy(health=hs.get("port"), **kw)
    jpol = JSwapPolicy(health=hs.get("jax"), **kw)
    rng = np.random.default_rng(len(str(kw)) + len(str(health)))
    last = None
    for seq in range(1, 41):
        step = seq + int(rng.integers(0, 3))
        versions = (step + 1 - rng.integers(0, 3, (3, 4))).astype(np.float32)
        drift = None if seq % 5 == 0 else float(rng.uniform(0, 1))
        worker = int(rng.integers(0, 3))
        tsnap = PlaneSnapshot(seq=seq, step=step, plane={},
                              versions=torch.from_numpy(versions),
                              w=torch.ones(3),
                              drift=None if drift is None
                              else torch.tensor(drift))
        jsnap = JPlaneSnapshot(seq=seq, step=step, plane={},
                               versions=jnp.asarray(versions),
                               w=jnp.ones(3),
                               drift=None if drift is None
                               else jnp.asarray(drift, jnp.float32))
        got = tpol.evaluate(tsnap, last_swap_step=last, worker=worker)
        want = jpol.evaluate(jsnap, last_swap_step=last, worker=worker)
        assert (got.accepted, got.reason, got.seq, got.step) == (
            want.accepted, want.reason, want.seq, want.step), seq
        assert got.staleness_max == pytest.approx(want.staleness_max,
                                                  rel=1e-6)
        assert (got.drift is None) == (want.drift is None)
        if got.drift is not None:
            assert got.drift == pytest.approx(want.drift, rel=1e-6)
        if got.accepted:
            last = step
    assert tpol.counts == jpol.counts
    assert (tpol.accepted, tpol.rejected, tpol.gated_rejections) == (
        jpol.accepted, jpol.rejected, jpol.gated_rejections)


# ---------------------------------------------------------------------------
# admission queue
# ---------------------------------------------------------------------------

def test_admission_bounded_depth_rejects_with_retry_hint():
    q = AdmissionQueue(max_depth=2)
    assert q.submit("a").accepted and q.submit("b").accepted
    t = q.submit("c")
    assert not t.accepted and t.reason == "queue-full"
    assert t.retry_after_s > 0.0
    assert q.depth == 2 and q.stats()["rejected"] == 1
    assert q.take(10) == ["a", "b"]             # FIFO order
    assert q.submit("c").accepted               # space freed
    with pytest.raises(ValueError):
        AdmissionQueue(max_depth=0)


def test_admission_deadline_drop():
    q = AdmissionQueue(max_depth=8)
    now = time.monotonic()
    q.submit("late", deadline_s=now - 1.0, now=now)     # already expired
    q.submit("ok", deadline_s=now + 60.0, now=now)
    q.submit("nolimit", now=now)
    got = q.take(10, now=now)
    assert got == ["ok", "nolimit"]
    s = q.stats()
    assert s["deadline_dropped"] == 1
    assert s["admitted"] == 2 and s["submitted"] == 3 and s["depth"] == 0


def test_admission_drain_ema_updates():
    q = AdmissionQueue(max_depth=8)
    now = time.monotonic()
    for i in range(4):
        q.submit(i, now=now)
    q.take(2, now=now)
    before = q.stats()["drain_ema_s"]
    q.take(2, now=now + 1.0)                    # 0.5 s/request measured
    assert q.stats()["drain_ema_s"] > before


# ---------------------------------------------------------------------------
# live swaps (fake loop: exact invariants)
# ---------------------------------------------------------------------------

class _FakeLoop:
    """Just enough ServeLoop surface for LiveServer.poll()."""

    def __init__(self):
        self.params = None
        self.params_version = None
        self.steps_run = 0

    def set_params(self, params, version=None):
        self.params = params
        self.params_version = version


def _leaves_all(tree, fill):
    leaves = tree_leaves(tree)
    assert len(leaves) == len(tree_leaves(_tiny_tree(0.0)))
    return all(torch.equal(x, torch.full(x.shape, fill)) for x in leaves)


def test_swap_is_atomic_across_groups():
    """Served params always come from exactly ONE published plane, and the
    version clocks travel with the plane they describe."""
    part = FlatPartition(_tiny_tree(0.0))
    assert part.num_groups >= 2                 # multi-group or no test
    pub = PlanePublisher()
    loop = _FakeLoop()
    srv = LiveServer(loop, part, pub)
    for step, fill in [(0, 1.0), (1, 2.0), (5, 7.0)]:
        snap = _publish(pub, part, fill, step)
        d = srv.poll()
        assert d.accepted
        assert _leaves_all(loop.params, fill)
        assert loop.params_version == (d.seq, step)
        np.testing.assert_array_equal(
            srv.swaps[-1].versions, np.full((1, part.num_groups), step + 1.0))
        # the served tree is a copy of the row, not views of the snapshot
        ptrs = {b.untyped_storage().data_ptr() for b in snap.plane.values()}
        assert not any(x.untyped_storage().data_ptr() in ptrs
                       for x in tree_leaves(loop.params))
    assert srv.swap_count == 3
    # two publishes between polls: only the newest is evaluated
    _publish(pub, part, 8.0, 6)
    _publish(pub, part, 9.0, 7)
    srv.poll()
    assert _leaves_all(loop.params, 9.0)
    assert srv.poll() is None                   # nothing unseen left


def test_rejected_plane_skipped_serving_continues():
    part = FlatPartition(_tiny_tree(0.0))
    pub = PlanePublisher()
    loop = _FakeLoop()
    srv = LiveServer(loop, part, pub, policy=SwapPolicy(max_drift=0.5))
    _publish(pub, part, 1.0, 0, drift=torch.tensor(0.0))
    assert srv.poll().accepted
    good = loop.params
    _publish(pub, part, 2.0, 1, drift=torch.tensor(9.0))  # must be gated
    d = srv.poll()
    assert not d.accepted and d.reason == "drift"
    assert loop.params is good                  # still serving the old tree
    assert loop.params_version == (1, 0)
    _publish(pub, part, 3.0, 2, drift=torch.tensor(0.1))  # swaps again
    assert srv.poll().accepted
    assert loop.params_version == (3, 2)
    assert srv.swap_count == 2
    assert srv.policy.gated_rejections == 1


def test_live_server_serves_selected_worker():
    part = FlatPartition(_tiny_tree(0.0))
    pub = PlanePublisher()
    flat1, flat2 = part.pack(_tiny_tree(1.0)), part.pack(_tiny_tree(2.0))
    plane = {g: torch.stack([flat1[g], flat2[g]]) for g in flat1}  # M=2
    loop = _FakeLoop()
    srv = LiveServer(loop, part, pub, worker=1)
    pub.publish(plane, torch.ones((2, part.num_groups)), torch.ones(2), 0)
    assert srv.poll().accepted
    assert _leaves_all(loop.params, 2.0)


def test_live_server_health_gate_keeps_serving():
    """A snapshot whose worker is suspect is refused; serving stays on the
    previous params."""
    part = FlatPartition(_tiny_tree(0.0))
    pub = PlanePublisher()
    health = PeerHealth(1)
    loop = _FakeLoop()
    srv = LiveServer(loop, part, pub, policy=SwapPolicy(health=health))
    _publish(pub, part, 1.0, 0)
    assert srv.poll().accepted
    health.mark_suspect(0, 1)
    _publish(pub, part, 2.0, 1)
    d = srv.poll()
    assert not d.accepted and d.reason == "unhealthy-source"
    assert _leaves_all(loop.params, 1.0) and srv.swap_count == 1


def test_publish_and_swap_under_thread_stress():
    """One publisher thread and three servers polling on threads of their
    own, with a short switch interval: every swap serves one whole plane
    (all leaves the fill of the snapshot it names), and each server's
    swaps go forward in publish order."""
    import threading

    part = FlatPartition(_tiny_tree(0.0))
    pub = PlanePublisher()
    servers = [LiveServer(_FakeLoop(), part, pub) for _ in range(3)]
    n, errors = 200, []
    done = threading.Event()

    def produce():
        for i in range(1, n + 1):
            _publish(pub, part, float(i), i)
        done.set()

    def consume(srv):
        try:
            seen = 0
            while not (done.is_set() and pub.latest(after_seq=seen) is None):
                if srv.poll() is None:
                    continue
                seq, step = srv.loop.params_version
                if seq <= seen or not _leaves_all(srv.loop.params,
                                                  float(step)):
                    raise AssertionError(f"swap {seq} after {seen}")
                seen = seq
        except AssertionError as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=produce)] + [
            threading.Thread(target=consume, args=(s,)) for s in servers]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert pub.stats.published == n
    for srv in servers:
        assert srv.loop.params_version == (n, n)  # each saw the last one


# ---------------------------------------------------------------------------
# end to end: trainer publishes, LiveServer swaps, against the JAX run
# ---------------------------------------------------------------------------

def _tiny_jcfg():
    from repro.configs.base import ModelConfig as JModelConfig

    return JModelConfig(name="tiny-lm", family="dense", num_layers=2,
                        d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                        vocab_size=64)


def _batches(steps=3):
    from repro.data.synthetic import SyntheticLM, make_worker_batches

    ds = SyntheticLM(vocab=64, seq_len=16, temperature=1.2)
    return [jax.tree.map(np.asarray, make_worker_batches(ds, 1, 4, t))
            for t in range(steps)]


def _live_schedule(st, srv, adm, batches, Request, step):
    """test_serving_live.py's schedule: 2 steps, serve a request, 1 step,
    serve another."""
    for t in range(2):
        st, _ = step(st, batches[t])
    assert adm.submit(Request(uid=0, prompt=np.asarray([1, 2], np.int32),
                              max_new_tokens=3)).accepted
    srv.run_until_idle()
    st, _ = step(st, batches[2])
    assert adm.submit(Request(uid=1, prompt=np.asarray([3], np.int32),
                              max_new_tokens=2)).accepted
    srv.run_until_idle()
    return st


@pytest.fixture(scope="module")
def jax_live():
    """The reference's monolithic live swap (M=1) on tiny-lm: its init
    params and the params it serves at the end."""
    from repro.core import make_backend as jax_make_backend
    from repro.launch.serve import Request as JRequest
    from repro.launch.serve import ServeLoop as JServeLoop
    from repro.models import build_model as jax_build_model
    from repro.optim import constant as jconstant
    from repro.optim import momentum as jmomentum
    from repro.serving import AdmissionQueue as JAdmissionQueue
    from repro.serving import LiveServer as JLiveServer
    from repro.serving import PlanePublisher as JPlanePublisher
    from repro.serving import SwapPolicy as JSwapPolicy

    jcfg = _tiny_jcfg()
    model = jax_build_model(jcfg)
    pub = JPlanePublisher()
    be = jax_make_backend(
        "prod", "layup", M=1,
        loss_fn=lambda p, b: model.loss_fn(p, b, block_k=32),
        optimizer=jmomentum(0.9), schedule=jconstant(0.05), fb_ratio=2,
        update_delay=1, measure_drift=True, publisher=pub)
    params = model.init(jax.random.PRNGKey(0))
    st = be.init(jax.random.PRNGKey(0), params)
    loop = JServeLoop(model, params, num_slots=2, max_len=16)
    adm = JAdmissionQueue(max_depth=8)
    srv = JLiveServer(loop, be.part, pub, policy=JSwapPolicy(),
                      admission=adm)
    _live_schedule(st, srv, adm, _batches(), JRequest,
                  lambda s, b: be.step(s, jax.tree.map(jnp.asarray, b),
                                       None))
    return {"cfg": jcfg, "params": jax.tree.map(np.asarray, params),
            "served": jax.tree.map(np.asarray, loop.params),
            "stats": srv.stats()}


@pytest.mark.parametrize("overlap", [False, True], ids=["monolithic",
                                                        "pipeline"])
def test_live_swap_end_to_end_matches_jax(jax_live, overlap, tmp_path,
                                          monkeypatch):
    """The port's trainer publishes each step, the LiveServer swaps the
    read plane into a real ServeLoop mid-serving: the served params equal
    the JAX run's at the plane tolerance, both lanes copy every publish,
    and nothing touches the filesystem."""
    from repro_torch.convert import to_torch
    from repro_torch.launch.serve import Request, ServeLoop
    from repro_torch.models import build_model

    monkeypatch.chdir(tmp_path)
    model = build_model(torch_cfg(jax_live["cfg"]))
    pub = PlanePublisher()
    be = make_backend("prod", "layup", M=1, loss_fn=model.loss_fn,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      fb_ratio=2, update_delay=1, measure_drift=True,
                      publisher=pub, overlap=overlap, device="cpu")
    params = to_torch(jax_live["params"], "cpu")
    st = be.init(None, params)
    loop = ServeLoop(model, params, num_slots=2, max_len=16, device="cpu")
    adm = AdmissionQueue(max_depth=8)
    srv = LiveServer(loop, be.part, pub, policy=SwapPolicy(), admission=adm)
    _live_schedule(st, srv, adm, _batches(), Request,
                  lambda s, b: be.step(s, b))
    assert pub.stats.published == 3
    # both lanes write their read plane in place later: every publish copies
    assert pub.stats.copied_planes == 3
    s, want = srv.stats(), jax_live["stats"]
    for k in ("tokens_emitted", "requests_completed", "swaps",
              "params_version", "steps_run", "swap_reasons"):
        assert s[k] == want[k], k
    assert s["admission"]["admitted"] == 2
    compare_planes(be.part.pack(loop.params),
                   be.part.pack(to_torch(jax_live["served"], "cpu")),
                   rtol=PLANE_TOL["rtol"])
    # swapped params == the trainer's read plane, unpacked (worker 0)
    expect = srv._unpack(pub.latest().plane)
    for a, b in zip(tree_leaves(loop.params), tree_leaves(expect)):
        assert torch.equal(a, b)
    assert list(tmp_path.iterdir()) == []       # zero files written


# ---------------------------------------------------------------------------
# inside the port: snapshots stay put, training is untouched
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("overlap", [False, True], ids=["monolithic",
                                                        "pipeline"])
def test_snapshot_unchanged_by_later_steps(overlap, use_pallas):
    """Both lanes write the read plane in place on later steps; the
    snapshot's copy must not move with it."""
    from _torch_parity import mlp_params, np_tree
    from _fixtures import mlp_batch

    pub = PlanePublisher()
    be = make_backend("prod", "layup", M=2, loss_fn=torch_mlp_loss,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      fb_ratio=2, update_delay=1, use_pallas=use_pallas,
                      overlap=overlap, publisher=pub, device="cpu")
    st = be.init(None, mlp_params())
    st, _ = be.step(st, np_tree(mlp_batch(0, M=2, b=8)))
    snap = pub.latest()
    kept = {g: b.clone() for g, b in snap.plane.items()}
    for g in snap.plane:
        assert torch.equal(snap.plane[g], st["read"][g])
        assert snap.plane[g].data_ptr() != st["read"][g].data_ptr()
    for t in (1, 2):
        st, _ = be.step(st, np_tree(mlp_batch(t, M=2, b=8)))
    for g in kept:
        assert torch.equal(snap.plane[g], kept[g]), g
    assert any(not torch.equal(st["read"][g], kept[g]) for g in kept)
    assert pub.stats.published == pub.stats.copied_planes == 3


@pytest.mark.parametrize("kw", [dict(), dict(overlap=True),
                                dict(use_pallas=True),
                                dict(use_pallas=True, overlap=True)],
                         ids=str)
def test_training_with_publisher_is_bit_identical(kw):
    pub = PlanePublisher()
    got = run_port(2, 2, 1, steps=4, publisher=pub, **kw)
    want = run_port(2, 2, 1, steps=4, **kw)
    assert_runs_equal(got, want)
    assert pub.stats.published == 4


def test_publisher_with_streams_raises():
    with pytest.raises(ValueError, match="streams > 1"):
        make_backend("prod", "layup", M=2, loss_fn=torch_mlp_loss,
                     optimizer=momentum(0.9), schedule=constant(0.05),
                     overlap=True, streams=2, publisher=PlanePublisher(),
                     device="cpu")


def test_port_serving_imports_neither_jax_nor_the_reference():
    """The serving package and the serve loop import with ``jax`` and
    ``repro`` blocked, and a train → publish → swap → serve run goes
    through."""
    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np
import repro_torch.serving
from repro_torch.serving import (live, policy, publisher, queue,
                                 LiveServer, PlanePublisher)
from repro_torch.launch import serve
from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import make_backend
from repro_torch.models import build_model
from repro_torch.optim import constant, momentum
cfg = ModelConfig(name="t", family="dense", num_layers=1, d_model=32,
                  num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=32)
model = build_model(cfg)
pub = PlanePublisher()
be = make_backend("prod", "layup", M=2, loss_fn=model.loss_fn,
                  optimizer=momentum(0.9), schedule=constant(0.05),
                  publisher=pub, device="cpu", overlap=True)
params = model.init(seed=0, device="cpu")
st = be.init(None, params)
toks = np.random.default_rng(0).integers(0, 32, (2, 2, 9))
st, m = be.step(st, {"tokens": toks[..., :-1], "labels": toks[..., 1:]})
loop = serve.ServeLoop(model, params, num_slots=2, max_len=8, device="cpu")
srv = LiveServer(loop, be.part, pub)
loop.submit(serve.Request(uid=0, prompt=np.asarray([1, 2]), max_new_tokens=2))
srv.run_until_idle()
assert srv.swap_count == 1 and loop.tokens_emitted == 2
assert not any(k.split(".")[0] in ("jax", "repro") for k in sys.modules)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-2000:]
