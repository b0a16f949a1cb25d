"""The port's prod training step against the JAX package's.

(a) M=1 in process: the JAX ``make_backend("prod", "layup",
    use_pallas=True)`` (Pallas in interpret mode) against the port on the
    CPU, per step: loss, update_staleness, layer_staleness, weight_sum,
    disagreement and the read plane.
(c) Inside the port, the fused route is bit-exact against the unfused one
    at M=1 (``x + u`` through α=1, β=0).
(d) Without CUDA, ``device=None`` raises.

(b), M ∈ {2, 4} against a JAX subprocess, is in
``test_torch_train_multiworker.py``.

Tolerances: see ``_torch_parity.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _fixtures import mlp_batch, mlp_problem  # noqa: E402
from _torch_parity import (compare_metrics, compare_planes,  # noqa: E402
                           np_tree, torch_mlp_loss)
from repro.core.backend import make_backend as jax_make_backend  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro.optim import momentum as jax_momentum  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core.backend import make_backend  # noqa: E402
from repro_torch.optim import constant, momentum  # noqa: E402


# ---------------------------------------------------------------------------
# (a) M = 1 in process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("R,D,stragglers", [(1, 0, None), (1, 1, None),
                                            (2, 1, None), (2, 1, [1])])
def test_m1_prod_step_matches_jax(R, D, stragglers):
    jloss_fn, jparams = mlp_problem()
    kw = dict(M=1, fb_ratio=R, update_delay=D, use_pallas=True,
              straggler_delays=stragglers)
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
    assert tbe.summary()["steps"] == 4.0


def test_m1_nonfinite_skip_matches_jax():
    """A NaN batch at step 1 (D=0): both skip every layer group, count the
    skips the same, and leave the plane untouched."""
    jloss_fn, jparams = mlp_problem()
    kw = dict(M=1, fb_ratio=1, update_delay=0, use_pallas=True)
    jbe = jax_make_backend("prod", "layup", loss_fn=jloss_fn,
                           optimizer=jax_momentum(0.9),
                           schedule=jax_constant(0.05), **kw)
    tbe = make_backend("prod", "layup", loss_fn=torch_mlp_loss,
                       optimizer=momentum(0.9), schedule=constant(0.05),
                       device="cpu", **kw)
    js = jbe.init(jax.random.PRNGKey(0), jparams)
    ts = tbe.init(None, np_tree(jparams))
    for t in range(3):
        b = np_tree(mlp_batch(t, M=1, b=8))
        if t == 1:
            b["x"] = b["x"].copy()
            b["x"][0, 0, 0] = np.nan
        before = {k: v.clone() for k, v in ts["read"].items()}
        js, jm = jbe.step(js, jax.tree.map(jnp.asarray, b),
                          jax.random.PRNGKey(t))
        ts, tm = tbe.step(ts, b, None)
        assert float(tm["nonfinite_skips"]) == float(jm["nonfinite_skips"])
        if t == 1:
            assert float(tm["nonfinite_skips"]) == 2.0
            for k in before:
                assert torch.equal(ts["read"][k], before[k])
        compare_planes(ts["read"], js["read"], rtol=1e-5)


# ---------------------------------------------------------------------------
# (c) inside the port; (d) device resolution
# ---------------------------------------------------------------------------


def test_fused_route_bit_exact_vs_unfused_at_m1():
    """At M=1 the fused lane is ``x + u`` through α=1, β=0: bitwise the
    unfused apply, so the whole trajectory matches exactly."""
    _, jparams = mlp_problem()
    params = np_tree(jparams)
    kw = dict(M=1, loss_fn=torch_mlp_loss, optimizer=momentum(0.9),
              schedule=constant(0.05), fb_ratio=2, update_delay=1,
              device="cpu")
    base = make_backend("prod", "layup", **kw)
    fused = make_backend("prod", "layup", use_pallas=True, **kw)
    bs, fs = base.init(None, params), fused.init(None, params)
    for t in range(4):
        b = np_tree(mlp_batch(t, M=1, b=8))
        bs, bm = base.step(bs, b)
        fs, fm = fused.step(fs, b)
        assert float(bm["loss"]) == float(fm["loss"]), t
        for k in bs["read"]:
            assert torch.equal(bs["read"][k], fs["read"][k]), (t, k)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    _, jparams = mlp_problem()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_backend("prod", "layup", M=1, loss_fn=torch_mlp_loss,
                     optimizer=momentum(0.9), schedule=constant(0.05))
    with pytest.raises(RuntimeError, match="CUDA"):
        to_torch(np_tree(jparams))


@pytest.mark.parametrize("kw,item", [
    (dict(overlap=True), "item 9"), (dict(streams=2), "item 9"),
    (dict(wire="int8"), "item 8"), (dict(compensate=0.5), "item 8"),
    (dict(faults=""), "item 10"), (dict(publisher=object()), "item 11"),
    (dict(tuning="x.json"), "item 12")])
def test_unported_options_name_their_roadmap_item(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        make_backend("prod", "layup", M=2, loss_fn=torch_mlp_loss,
                     optimizer=momentum(0.9), schedule=constant(0.05),
                     device="cpu", **kw)
