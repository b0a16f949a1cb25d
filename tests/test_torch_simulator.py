"""The port's copy of the event simulator and its ``"event"`` backend
against the JAX package's: every step's dict and every ``SimResult``
field EQUAL (the same numpy arithmetic), for every algorithm, coupled,
decoupled and with stragglers; the validations raise alike; the
reference's behavioural checks on the copy."""
import dataclasses

import numpy as np
import pytest

from repro.core import make_backend as jax_make_backend
from repro.core import simulator as J
from repro_torch.core import simulator as T
from repro_torch.core.backend import make_backend

HW = dict(fwd_time=1.0, bwd_ratio=2.0, num_layers=24, model_bytes=1.6e9,
          bandwidth=25e9, allreduce_bandwidth=100e9)
SLOW_NIC = dict(HW, bandwidth=0.45e9)
ALGOS = ["ddp", "localsgd", "slowmo", "co2", "gosgd", "adpsgd", "layup",
         "layup-block", "layup-hypercube"]
GOSSIP = ["gosgd", "layup", "layup-block", "layup-hypercube"]
STRAGGLERS = np.array([4.0, 0, 0, 0, 1.0, 0, 0, 0])


def _result_fields(r):
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}


def _assert_runs_equal(algo, hw, iters=30, **kw):
    js = J.EventSimulator(algo, M=8, hw=J.HardwareModel(**hw), **kw)
    ts = T.EventSimulator(algo, M=8, hw=T.HardwareModel(**hw), **kw)
    for _ in range(iters):
        assert ts.step() == js.step()
    got, want = _result_fields(ts.result()), _result_fields(js.result())
    np.testing.assert_array_equal(got.pop("iter_times"),
                                  want.pop("iter_times"))
    assert got == want


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("hw", [HW, SLOW_NIC], ids=["fast", "slow_nic"])
def test_coupled_equal(algo, hw):
    _assert_runs_equal(algo, hw, sync_every=4)


@pytest.mark.parametrize("algo", ALGOS)
def test_stragglers_equal(algo):
    _assert_runs_equal(algo, HW, straggler_delays=STRAGGLERS, seed=3)


@pytest.mark.parametrize("algo", GOSSIP)
@pytest.mark.parametrize("R,D", [(1, 1), (2, 1), (2, 3)])
def test_decoupled_equal(algo, R, D):
    _assert_runs_equal(algo, SLOW_NIC, fb_ratio=R, update_delay=D,
                       straggler_delays=STRAGGLERS)


@pytest.mark.parametrize("algo", ALGOS)
def test_event_backend_summary_equal(algo):
    """``make_backend("event")`` over 12 steps: each step's metrics and the
    summary equal the JAX backend's (block/hypercube through the alias)."""
    kw = dict(M=8, sync_every=4, straggler_delays=STRAGGLERS)
    jb = jax_make_backend("event", algo, hw=J.HardwareModel(**HW), **kw)
    tb = make_backend("event", algo, hw=T.HardwareModel(**HW), **kw)
    js, ts = jb.init(None), tb.init(None)
    for _ in range(12):
        js, jm = jb.step(js, None, None)
        ts, tm = tb.step(ts, None, None)
        assert tm == jm
    assert tb.summary() == jb.summary()
    assert tb.name == jb.name


def test_straggler_sweep_equal():
    kw = dict(M=8, iters=20, delays=(0, 2, 4))
    assert (T.straggler_sweep(ALGOS[:7], hw=T.HardwareModel(**HW), **kw)
            == J.straggler_sweep(ALGOS[:7], hw=J.HardwareModel(**HW), **kw))


@pytest.mark.parametrize("algo,kw,match", [
    ("ddp", dict(fb_ratio=2), "decoupled execution"),
    ("adpsgd", dict(update_delay=1), "rendezvous"),
    ("nope", {}, "unknown algo")])
def test_validation_raises_alike(algo, kw, match):
    for mod in (J, T):
        with pytest.raises(ValueError, match=match):
            mod.simulate(algo, M=4, iters=2, hw=mod.HardwareModel(), **kw)
    with pytest.raises(ValueError, match=match):
        make_backend("event", algo, M=4, **kw)


def test_paper_orderings_on_the_copy():
    """The reference's behavioural checks: DDP pays the all-reduce, LayUp's
    MFU is at least DDP's, the decoupled lane never stalls and scales the
    forward throughput by R, staleness grows with D."""
    hw = T.HardwareModel(**HW)
    r_ddp = T.simulate("ddp", M=8, iters=50, hw=hw)
    r_layup = T.simulate("layup", M=8, iters=50, hw=hw)
    assert r_ddp.total_time > r_layup.total_time
    assert r_layup.mfu >= r_ddp.mfu
    slow = T.HardwareModel(**SLOW_NIC)
    cpl = T.simulate("layup", M=8, iters=50, hw=slow)
    dec = T.simulate("layup", M=8, iters=50, hw=slow, update_delay=1)
    assert dec.total_time <= cpl.total_time + 1e-9
    assert dec.utilization == pytest.approx(1.0)
    r2 = T.simulate("layup", M=8, iters=50, hw=hw, fb_ratio=2,
                    update_delay=1)
    assert r2.fwd_passes_per_s == pytest.approx(2 * r2.updates_per_s)
    r3 = T.simulate("layup", M=8, iters=60, hw=hw, update_delay=3)
    r1 = T.simulate("layup", M=8, iters=60, hw=hw, update_delay=1)
    assert 0.0 < r1.mean_grad_staleness < r3.mean_grad_staleness
