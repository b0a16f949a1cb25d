"""The port's prod training step against the JAX package's.

(a) M=1 in process: the JAX ``make_backend("prod", "layup",
    use_pallas=True)`` (Pallas in interpret mode) against the port on the
    CPU, per step: loss, update_staleness, layer_staleness, weight_sum,
    disagreement and the read plane.
(c) Inside the port, the fused route is bit-exact against the unfused one
    at M=1 (``x + u`` through α=1, β=0).
(d) Without CUDA, ``device=None`` raises.
(e) The int8 wire and delay compensation (DESIGN.md §14): at M=1 int8 is
    bit-exact against ``wire="param"`` (nothing crosses the wire);
    ``compensate`` is a bit-exact no-op at D=0 and engages at D=1; the
    compensated update lane and the M=1 step against the JAX package's;
    ``summary()``'s wire fields against the JAX backend's.

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
from repro.core.layerview import FlatPartition as JaxFlatPartition  # noqa: E402,E501
from repro.launch.train import backward_update_lane as jax_update_lane  # noqa: E402,E501
from repro.optim import constant as jax_constant  # noqa: E402
from repro.optim import momentum as jax_momentum  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core.backend import make_backend  # noqa: E402
from repro_torch.launch.train import backward_update_lane  # noqa: E402
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
    pytest.param(dict(overlap=True, streams=2), "ring", id="kw8-item 15"),
    pytest.param(dict(flat=False), None, id="kw9-item 15")])
def test_ranked_streams_and_flat_false_give_the_same_runs(kw, item,
                                                         tmp_path):
    """``mesh=`` (the multi-GPU ring, item 15b) takes a ``WorkerMesh``
    (anything else is a ``TypeError``); over a process group (here one
    gloo rank) the stream engine (item 15c) gives the one-process run's
    numbers bit for bit.
    ``flat=False`` trains on the flat plane, the port's one state layout:
    the numbers of ``flat=True`` bit for bit (the reference's legacy state
    gives its flat plane's), with the options the reference keeps to the
    flat plane too."""
    from _torch_parity import assert_runs_equal, run_port

    if item is not None:
        import torch.distributed as dist
        from repro_torch.launch.mesh import WorkerMesh

        common = dict(loss_fn=torch_mlp_loss, optimizer=momentum(0.9),
                      schedule=constant(0.05), device="cpu")
        with pytest.raises(TypeError, match="WorkerMesh"):
            make_backend("prod", "layup", M=2, mesh=object(), **common)
        dist.init_process_group("gloo", rank=0, world_size=1,
                                init_method=f"file://{tmp_path / 'store'}")
        try:
            got = run_port(2, 2, 1, steps=3, **kw,
                           mesh=WorkerMesh(2, "cpu", dist.group.WORLD))
        finally:
            dist.destroy_process_group()
        assert got[3].mesh is not None
        assert_runs_equal(got, run_port(2, 2, 1, steps=3, **kw))
        return
    for opts in (dict(), dict(use_pallas=True, wire="int8",
                              compensate=0.5, faults="")):
        got = run_port(2, 2, 1, steps=3, **kw, **opts)
        assert_runs_equal(got, run_port(2, 2, 1, steps=3, **opts))
    be = got[3]
    read = be.export_params(be.init(None, np_tree(mlp_problem()[1])))
    assert sorted(read) == ["l1", "l2"] and read["l1"].shape[0] == 2


def test_streams_without_overlap_raises():
    """As the JAX backend: streams are a property of the pipeline engine."""
    with pytest.raises(ValueError, match="overlap=True"):
        make_backend("prod", "layup", M=2, loss_fn=torch_mlp_loss,
                     optimizer=momentum(0.9), schedule=constant(0.05),
                     device="cpu", streams=2)


# ---------------------------------------------------------------------------
# (e) the int8 wire and delay compensation
# ---------------------------------------------------------------------------


def _run_port(steps=4, M=1, **kw):
    """Losses and final read plane of the port's prod backend on the MLP
    fixture (CPU)."""
    _, jparams = mlp_problem()
    be = make_backend("prod", "layup", M=M, loss_fn=torch_mlp_loss,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      device="cpu", **kw)
    st = be.init(None, np_tree(jparams))
    losses = []
    for t in range(steps):
        st, m = be.step(st, np_tree(mlp_batch(t, M=M, b=8)))
        losses.append(float(m["loss"]))
    return losses, st, be


@pytest.mark.parametrize("use_pallas", [True, False])
def test_int8_bit_exact_vs_param_wire_at_m1(use_pallas):
    """At M=1 nothing crosses the wire: the fused route applies ``x + u``
    through gossip_mix and passes the residual through; the plain route is
    the identity."""
    kw = dict(fb_ratio=2, update_delay=1, use_pallas=use_pallas)
    ref, rs, _ = _run_port(**kw)
    got, gs, be = _run_port(wire="int8", **kw)
    assert got == ref
    for k in rs["read"]:
        assert torch.equal(gs["read"][k], rs["read"][k])
        assert torch.equal(gs["resid"][k], torch.zeros_like(gs["resid"][k]))
    assert be.summary()["wire_dtype"] == "int8"


@pytest.mark.parametrize("wire", ["param", "int8"])
def test_summary_wire_fields_match_jax(wire):
    jloss_fn, jparams = mlp_problem()
    jbe = jax_make_backend("prod", "layup", M=1, loss_fn=jloss_fn,
                           optimizer=jax_momentum(0.9),
                           schedule=jax_constant(0.05), wire=wire)
    jbe.init(jax.random.PRNGKey(0), jparams)
    _, _, tbe = _run_port(steps=1, wire=wire)
    js, ts = jbe.summary(), tbe.summary()
    assert ts["wire_dtype"] == js["wire_dtype"] == wire
    assert ts["wire_bytes_per_round"] == js["wire_bytes_per_round"]


def test_int8_wire_bytes_of_gpt2_medium():
    """``plane_nbytes(wire="int8")`` over GPT-2 Medium's groups (meta
    tensors, nothing allocated): 468,360,320 B, 0.258 x the f32 plane."""
    from repro_torch.configs import get_config
    from repro_torch.core.layerview import FlatPartition
    from repro_torch.core.pytree import tree_map
    from repro_torch.models.transformer import decoder_specs

    specs = decoder_specs(get_config("gpt2-medium"))
    part = FlatPartition(tree_map(
        lambda sp: torch.empty(sp.shape, device="meta"), specs))
    assert part.plane_nbytes("int8") == 468_360_320
    assert part.plane_nbytes() == 1_816_666_112
    with pytest.raises(ValueError, match="wire"):
        part.plane_nbytes("fp4")


def test_compensate_noop_at_d0_and_engages_at_d1():
    kw = dict(fb_ratio=1, use_pallas=True)
    ref, rs, _ = _run_port(update_delay=0, **kw)
    got, gs, _ = _run_port(update_delay=0, compensate=0.5, **kw)
    assert got == ref
    for k in rs["read"]:
        assert torch.equal(gs["read"][k], rs["read"][k])
    raw, _, _ = _run_port(update_delay=1, **kw)
    comp, cs, _ = _run_port(update_delay=1, compensate=0.5, **kw)
    assert raw != comp
    assert raw[:2] == comp[:2]  # the FIFO's warm-up: nothing stale yet


@pytest.mark.parametrize("apply", [True, False])
def test_compensated_update_lane_matches_jax(apply):
    """Three steps of the D=1 update lane with λ=0.5 on the same params,
    gradients and θ: the applied params and ``theta_new`` against the JAX
    lane's at rtol 1e-6 (XLA may contract the correction into FMAs).
    ``apply=False`` applies the deltas IN PLACE, as the fused mix does, so
    a ``theta_new`` that aliased the write plane would show here."""
    _, jparams = mlp_problem()
    jpart = JaxFlatPartition(jparams)
    jplane = jpart.pack(jparams)
    tplane = {k: torch.from_numpy(np.array(v))[None]
              for k, v in jplane.items()}
    rng = np.random.default_rng(0)
    jupd = jax_update_lane(jax_momentum(0.9), jax_constant(0.05),
                           update_delay=1, compensate=0.5)
    tupd = backward_update_lane(momentum(0.9), constant(0.05),
                                update_delay=1, compensate=0.5, apply=apply)
    jopt = jax_momentum(0.9).init(jplane)
    topt = momentum(0.9).init(tplane)
    jfifo = {"g": {k: jnp.zeros((1,) + v.shape, v.dtype)
                   for k, v in jplane.items()},
             "stamp": jnp.full((1,), -1.0, jnp.float32)}
    tfifo = {"g": {k: torch.zeros((1, 1) + tuple(v.shape[1:]))
                   for k, v in tplane.items()},
             "stamp": torch.full((1,), -1.0)}
    jtheta = {k: v - 0.01 for k, v in jplane.items()}
    ttheta = {k: torch.from_numpy(np.array(v))[None]
              for k, v in jtheta.items()}
    for t in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in jplane.items()}
        jplane, jopt, jfifo, jstale, _, jtheta = jupd(
            jplane, jopt, {k: jnp.asarray(v) for k, v in g.items()}, jfifo,
            jnp.int32(t), theta=jtheta)
        out, topt, tfifo, tstale, _, ttheta = tupd(
            tplane, topt, {k: torch.from_numpy(v)[None]
                           for k, v in g.items()}, tfifo, t, theta=ttheta)
        if apply:
            tplane = out
        else:
            for k, u in out.items():
                tplane[k].add_(u)
        assert float(tstale) == float(jstale) == (1.0 if t else 0.0)
        for k in jplane:
            np.testing.assert_allclose(tplane[k][0].numpy(),
                                       np.asarray(jplane[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k} step {t}")
            np.testing.assert_allclose(ttheta[k][0].numpy(),
                                       np.asarray(jtheta[k]), rtol=1e-6,
                                       atol=1e-7,
                                       err_msg=f"theta {k} step {t}")


@pytest.mark.parametrize("wire", ["param", "int8"])
def test_m1_compensated_prod_step_matches_jax(wire):
    jloss_fn, jparams = mlp_problem()
    kw = dict(M=1, fb_ratio=2, update_delay=1, use_pallas=True,
              compensate=0.5, wire=wire)
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
        compare_planes(ts["theta"], js["theta"], rtol=1e-5)


def test_wire_and_compensate_validation():
    kw = dict(M=1, loss_fn=torch_mlp_loss, optimizer=momentum(0.9),
              schedule=constant(0.05), device="cpu")
    with pytest.raises(ValueError, match="wire"):
        make_backend("prod", "layup", wire="fp4", **kw)
    with pytest.raises(ValueError, match="compensate"):
        make_backend("prod", "layup", compensate=-1.0, **kw)


def test_int8_backend_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_backend("prod", "layup", M=4, loss_fn=torch_mlp_loss,
                     optimizer=momentum(0.9), schedule=constant(0.05),
                     fb_ratio=2, update_delay=1, use_pallas=True,
                     wire="int8", compensate=0.5)
