"""The Model-level step factories of the port (``make_step`` and the builders
it routes to, ``launch/mesh.py``, the abstract shapes) against the JAX
package's.

(a) Abstract shapes: ``input_specs`` at every ``INPUT_SHAPES`` kind,
    ``Model.abstract_params``, ``param_count`` and ``Model.logical_axes``
    equal to the JAX package's for all twelve configs.
(b) M=1 in process, on ``reduced(stablelm-1.6b)`` (S=16, B=4, 3 steps):
    the JAX ``make_step`` on a (1, 1) mesh (Pallas in interpret mode)
    against the port's on ``WorkerMesh(1, "cpu")``: DDP, lockstep LayUp
    (``accum_steps`` 1 and 2), the decoupled step (R=2, D=1, fused and
    plain), prefill and decode.
(c) M=2 against one JAX subprocess shared by the module (donation dropped,
    as in ``test_torch_train_multiworker.py``): lockstep LayUp with
    ``use_pallas`` and ``accum_steps=2``, and the port's ``flat=False`` (run
    on the flat plane) against the reference's legacy tree state.
(d) The port's own pins, bit for bit: ``flat=False`` against
    ``flat=True``, the Model path against the backend path, the engines
    against the monolithic step, the empty fault plan against none; the
    tuning record and the fault plan through ``make_step``; the pure
    ``gossip_mix`` route and ``accum_steps`` against their plain
    counterparts within the reference's tolerances.
(e) Every ``ValueError`` route of the reference's ``make_step`` raises in
    both packages, but for the reference's flat-only rules: the port has
    one state layout, so ``flat=False`` takes every option.

Tolerances: losses and metrics rtol 1e-5, parameters and planes rtol 1e-4
with atol 1e-6, logits and caches rtol 1e-4 with atol 1e-5
(``_torch_parity.py``, ``test_torch_decode.py``).
"""
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _subproc import run_sub  # noqa: E402
from _torch_parity import (assert_tree_close, compare_planes,  # noqa: E402
                           host, model_pair)
from repro.configs import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import ShapeConfig as JaxShape  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import input_specs as jax_input_specs  # noqa: E402
from repro.launch.train import make_decoupled_state as jax_state  # noqa: E402
from repro.launch.train import make_step as jax_make_step  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.layers import param_count as jax_param_count  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro.optim import momentum as jax_momentum  # noqa: E402
from repro_torch.configs import (INPUT_SHAPES, ShapeConfig,  # noqa: E402
                                 get_config, input_specs, list_configs,
                                 reduced)
from repro_torch.convert import to_torch, unflatten_npz  # noqa: E402
from repro_torch.core.backend import make_backend  # noqa: E402
from repro_torch.core.layerview import FlatPartition  # noqa: E402
from repro_torch.core.pytree import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch.mesh import WorkerMesh  # noqa: E402
from repro_torch.launch.train import make_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import param_count  # noqa: E402
from repro_torch.models.transformer import alloc_cache  # noqa: E402
from repro_torch.optim import constant, momentum  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "stablelm-1.6b"
S, B, STEPS = 16, 4, 3
LR = 0.05
# the decoupled step's metrics (the Model path computes no disagreement)
STEP_METRICS = ("loss", "update_staleness", "layer_staleness", "weight_sum",
                "staleness_mean")
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)


def _batches(vocab, B, n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def _stack(tree, M):
    return tree_map(lambda x: x[None].expand((M,) + tuple(x.shape)), tree)


def _jax_mesh():
    """A (1, 1) mesh with Auto axes. jax 0.9's ``make_mesh`` defaults to
    Explicit axes, under which the reference's embedding gather in a jit
    with ``model``-sharded params raises for want of ``out_sharding``; the
    reference was written for Auto (GSPMD) axes."""
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _jnp(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _port(model, M=1, **kw):
    """The port's step of ``model`` on M CPU workers at (S, M·B)."""
    kind = kw.pop("kind", "train")
    batch = kw.pop("batch", M * B)
    return make_step(model, WorkerMesh(M, "cpu"),
                     ShapeConfig("t", S, batch, kind),
                     optimizer=momentum(0.9), schedule=constant(LR), **kw)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """The module's steps are many small CPU ops; with the test workers
    sharing the machine, PyTorch's intra-op thread pool in each of them
    oversubscribes the cores and slows these tests many times over. One
    thread for the module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params) of one JAX init of
    ``reduced(stablelm-1.6b)``."""
    return model_pair(ARCH)


# ---------------------------------------------------------------------------
# (a) abstract shapes
# ---------------------------------------------------------------------------


def _torch_dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", list_configs())
def test_abstract_shapes_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        got = input_specs(cfg, shape)
        want = jax_input_specs(jcfg, JAX_SHAPES[name])
        assert sorted(got) == sorted(want), (arch, name)
        for k, (shp, dt) in got.items():
            assert shp == tuple(want[k].shape), (arch, name, k)
            assert _torch_dtype_name(dt) == np.dtype(want[k].dtype).name
    model, jmodel = build_model(cfg), jax_build_model(jcfg)
    abstract, jabstract = model.abstract_params(), jmodel.abstract_params()
    assert all(t.device.type == "meta" for t in tree_leaves(abstract))
    axes, jaxes = model.logical_axes(), jmodel.logical_axes()
    flat = jax.tree_util.tree_flatten_with_path(jabstract)[0]
    assert len(flat) == len(tree_leaves(abstract))
    for path, want in flat:
        got, got_axes, want_axes = abstract, axes, jaxes
        for e in path:
            got, got_axes, want_axes = (got[e.key], got_axes[e.key],
                                        want_axes[e.key])
        key = jax.tree_util.keystr(path)
        assert tuple(got.shape) == tuple(want.shape), (arch, key)
        assert _torch_dtype_name(got.dtype) == np.dtype(want.dtype).name
        assert tuple(got_axes) == tuple(want_axes), (arch, key)
    assert param_count(abstract) == jax_param_count(jabstract)


# ---------------------------------------------------------------------------
# (b) M = 1 in process
# ---------------------------------------------------------------------------


def test_ddp_step_matches_jax(pair):
    jm, jp, tm, tp = pair
    jstep = jax_make_step(jm, _jax_mesh(), JaxShape("t", S, B, "train"),
                          algo="ddp", optimizer=jax_momentum(0.9),
                          schedule=jax_constant(LR))
    tstep = _port(tm, algo="ddp")
    assert tstep.describe == jstep.describe == "ddp train"
    jparams = jax.tree.map(jnp.array, jp)
    jopt = jax_momentum(0.9).init(jparams)
    tparams, topt = tstep.init_state(tp)
    for t, b in enumerate(_batches(jm.cfg.vocab_size, B)):
        jparams, jopt, jl = jstep.fn(jparams, jopt, _jnp(b), jnp.int32(t))
        tparams, topt, tl = tstep.fn(tparams, topt, b, t)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                   err_msg=f"loss at step {t}")
    assert_tree_close(tparams, jparams, "params", **PARAM_TOL)


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_lockstep_step_matches_jax(pair, accum_steps):
    jm, jp, tm, tp = pair
    jstep = jax_make_step(jm, _jax_mesh(), JaxShape("t", S, B, "train"),
                          optimizer=jax_momentum(0.9),
                          schedule=jax_constant(LR), accum_steps=accum_steps)
    tstep = _port(tm, accum_steps=accum_steps)
    jparams = jax.tree.map(lambda p: jnp.array(p[None]), jp)
    jopt = jax.vmap(jax_momentum(0.9).init)(jparams)
    jw = jnp.ones((1,), jnp.float32)
    tparams, topt, tw = tstep.init_state(_stack(tp, 1))
    for t, b in enumerate(_batches(jm.cfg.vocab_size, B)):
        jparams, jopt, jw, jl = jstep.fn(jparams, jopt, jw, _jnp(b),
                                         jnp.int32(t), jnp.int32(0))
        tparams, topt, tw, tl = tstep.fn(tparams, topt, tw, b, t, 0)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                   err_msg=f"loss at step {t}")
    assert_tree_close(tparams, jparams, "params", **PARAM_TOL)
    np.testing.assert_array_equal(host(tw), np.asarray(jw))


def _compare_step_metrics(tm, jm, t):
    for k in STEP_METRICS:
        np.testing.assert_allclose(host(tm[k]), np.asarray(jm[k]),
                                   rtol=1e-5, atol=1e-7,
                                   err_msg=f"{k} at step {t}")


@pytest.mark.parametrize("use_pallas", [True, False])
def test_decoupled_step_matches_jax(pair, use_pallas):
    jm, jp, tm, tp = pair
    kw = dict(fb_ratio=2, update_delay=1, use_pallas=use_pallas)
    jstep = jax_make_step(jm, _jax_mesh(), JaxShape("t", S, B, "train"),
                          optimizer=jax_momentum(0.9),
                          schedule=jax_constant(LR), **kw)
    tstep = _port(tm, **kw)
    js = jax_state(jax.tree.map(lambda p: jnp.array(p[None]), jp),
                   jax_momentum(0.9), update_delay=1)
    ts = tstep.init_state(_stack(tp, 1))
    for t, b in enumerate(_batches(jm.cfg.vocab_size, B)):
        js, jmet = jstep.fn(js, _jnp(b), jnp.int32(t), jnp.int32(0))
        ts, tmet = tstep.fn(ts, b, t, 0)
        _compare_step_metrics(tmet, jmet, t)
    compare_planes(ts["read"], js["read"], rtol=1e-4)


def test_prefill_and_decode_steps_match_jax(pair):
    jm, jp, tm, tp = pair
    B2 = 2
    toks = _batches(jm.cfg.vocab_size, B2, n=1, seed=3)[0]["tokens"]
    jpre = jax_make_step(jm, _jax_mesh(), JaxShape("p", S, B2, "prefill"))
    tpre = _port(tm, kind="prefill", batch=B2)
    jc, jl = jpre.fn(jp, {"tokens": jnp.asarray(toks)})
    tc, tl = tpre.fn(tp, {"tokens": toks})
    np.testing.assert_allclose(host(tl), np.asarray(jl), **LOGIT_TOL)
    assert_tree_close(tc, jc, "prefill cache", **LOGIT_TOL)
    # decode from a zero cache of S slots, three tokens
    jdec = jax_make_step(jm, _jax_mesh(), JaxShape("d", S, B2, "decode"))
    tdec = _port(tm, kind="decode", batch=B2)
    assert tdec.abstract_args[2:] == (((B2, 1), torch.int32),
                                      ((B2,), torch.int32))
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jm.cache_specs(B2, S))
    tcache = alloc_cache(tdec.abstract_args[1], device="cpu")
    for pos in range(3):
        tok = toks[:, pos:pos + 1]
        jlog, jcache = jdec.fn(jp, jcache, jnp.asarray(tok),
                               jnp.full((B2,), pos, jnp.int32))
        tlog, tcache = tdec.fn(tp, tcache, torch.from_numpy(tok),
                               torch.full((B2,), pos, dtype=torch.int32))
        np.testing.assert_allclose(host(tlog), np.asarray(jlog),
                                   **LOGIT_TOL, err_msg=f"decode {pos}")
    assert_tree_close(tcache, jcache, "decode cache", **LOGIT_TOL)


# ---------------------------------------------------------------------------
# (c) M = 2 against a JAX subprocess
# ---------------------------------------------------------------------------

M2, B2_GLOBAL = 2, 8

_REF_CODE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path[:0] = [{repo!r}, os.path.join({repo!r}, "tests")]
import jax, jax.numpy as jnp, numpy as np

# Under jax 0.9 the reference's M>1 step fails to run with its state
# donated (ROADMAP queue 3, Ref-1); donation does not change numerics.
_jit = jax.jit
def _jit_without_donation(f, *a, **k):
    k.pop("donate_argnums", None)
    return _jit(f, *a, **k)
jax.jit = _jit_without_donation

from repro.configs import ShapeConfig, get_config, reduced
from repro.launch.train import make_decoupled_state, make_step
from repro.models import build_model
from repro.optim import constant, momentum

def flat(prefix, tree):
    return {{prefix + "/".join(str(e.key) for e in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}}

M, S, B, STEPS = {M}, {S}, {B}, {steps}
m = build_model(reduced(get_config({arch!r})))
params = m.init(jax.random.PRNGKey(0))
# Auto axes, as the reference was written for (see ``_jax_mesh``)
mesh = jax.make_mesh((M, 1), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
shape = ShapeConfig("t", S, B, "train")
opt = momentum(0.9)
rng = np.random.default_rng(7)
batches = []
for t in range(STEPS):
    tk = rng.integers(0, m.cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batches.append({{"tokens": tk[:, :-1], "labels": tk[:, 1:]}})
out = flat("params/", params)
for t, b in enumerate(batches):
    out.update({{f"batch{{t}}/{{k}}": v for k, v in b.items()}})
sp = jax.tree.map(lambda p: jnp.broadcast_to(p[None], (M,) + p.shape),
                  params)

step = make_step(m, mesh, shape, optimizer=opt, schedule=constant({lr}),
                 accum_steps=2, use_pallas=True)
p, o = jax.tree.map(jnp.array, sp), jax.vmap(opt.init)(sp)
w = jnp.full((M,), 1.0 / M, jnp.float32)
for t, b in enumerate(batches):
    p, o, w, loss = step.fn(p, o, w, {{k: jnp.asarray(v) for k, v in
                                       b.items()}},
                            jnp.int32(t), jnp.int32(0))
    out[f"lockstep/loss{{t}}"] = np.asarray(loss)
out.update(flat("lockstep/params/", p))
out["lockstep/w"] = np.asarray(w)

step = make_step(m, mesh, shape, optimizer=opt, schedule=constant({lr}),
                 fb_ratio=2, update_delay=1, flat=False)
st = make_decoupled_state(sp, opt, update_delay=1, flat=False)
for t, b in enumerate(batches):
    st, met = step.fn(st, {{k: jnp.asarray(v) for k, v in b.items()}},
                      jnp.int32(t), jnp.int32(0))
    for k in {metrics!r}:
        out[f"legacy/{{k}}{{t}}"] = np.asarray(met[k])
out.update(flat("legacy/read/", st["read"]))
np.savez({path!r}, **out)
print("ok")
"""


@pytest.fixture(scope="module")
def reference_m2(tmp_path_factory):
    path = tmp_path_factory.mktemp("model_path") / "ref.npz"
    run_sub(_REF_CODE.format(repo=REPO, M=M2, S=S, B=B2_GLOBAL, steps=STEPS,
                             arch=ARCH, lr=LR, metrics=STEP_METRICS,
                             path=str(path)), timeout=900)
    ref = dict(np.load(path))
    params = to_torch(unflatten_npz(ref, "params"), "cpu")
    batches = [unflatten_npz(ref, f"batch{t}") for t in range(STEPS)]
    return ref, params, batches


def test_m2_lockstep_pure_mix_and_accum_match_jax(reference_m2):
    ref, params, batches = reference_m2
    model = build_model(reduced(get_config(ARCH)))
    step = _port(model, M=M2, accum_steps=2, use_pallas=True)
    p, o, w = step.init_state(_stack(params, M2))
    for t, b in enumerate(batches):
        p, o, w, loss = step.fn(p, o, w, b, t, 0)
        np.testing.assert_allclose(float(loss), ref[f"lockstep/loss{t}"],
                                   rtol=1e-5, err_msg=f"loss at step {t}")
    want = unflatten_npz(ref, "lockstep/params")
    assert_tree_close(p, jax.tree.map(jnp.asarray, want), "params",
                      **PARAM_TOL)
    np.testing.assert_allclose(host(w), ref["lockstep/w"], rtol=1e-6)


def test_m2_legacy_decoupled_matches_jax(reference_m2):
    """The port's ``flat=False`` (the flat plane) against the reference's
    legacy tree state."""
    ref, params, batches = reference_m2
    model = build_model(reduced(get_config(ARCH)))
    step = _port(model, M=M2, fb_ratio=2, update_delay=1, flat=False)
    st = step.init_state(_stack(params, M2))
    for t, b in enumerate(batches):
        st, met = step.fn(st, b, t, 0)
        _compare_step_metrics(
            met, {k: ref[f"legacy/{k}{t}"] for k in STEP_METRICS}, t)
    read = FlatPartition(model.abstract_params()).unpack(st["read"])
    assert_tree_close(read,
                      jax.tree.map(jnp.asarray,
                                   unflatten_npz(ref, "legacy/read")),
                      "read", **PARAM_TOL)


# ---------------------------------------------------------------------------
# (d) the port's own pins
# ---------------------------------------------------------------------------


def _run(step, params, batches, M, shift_idx=None):
    """Each step's metrics (host floats) and the final state of a decoupled
    ``step`` (a ProdStep or a PipelineStep); the stream engine's threads
    are closed on the way out."""
    st = step.init_state(_stack(params, M))
    hist = []
    try:
        for t, b in enumerate(batches):
            if step.chaos is not None:
                st, b = step.chaos.before_step(st, b, t)
            s = 0 if shift_idx is None else shift_idx[t]
            st, m = step.fn(st, b, t, s)
            hist.append({k: host(m[k]).tolist() for k in STEP_METRICS})
        engine = getattr(step, "engine", None)
        if hasattr(engine, "materialize"):
            st = engine.materialize(st)
    finally:
        engine = getattr(step, "engine", None)
        if hasattr(engine, "close"):
            engine.close()
    return hist, st


@pytest.fixture(scope="module")
def port_model():
    model = build_model(reduced(get_config(ARCH)))
    return model, model.init(seed=0, device="cpu")


def test_legacy_state_bit_exact_vs_flat_plane(port_model):
    """``flat=False`` runs on the flat plane: the decoupled Model path
    with it gives ``flat=True``'s losses, layer staleness (every metric) and
    read plane bit for bit, as the reference's legacy state gives its flat
    plane's (``test_flat_m2_mesh_exact_vs_legacy_oracle``)."""
    model, params = port_model
    batches = _batches(model.cfg.vocab_size, 2 * B)
    kw = dict(M=2, fb_ratio=2, update_delay=1)
    flat_step, legacy_step = _port(model, **kw), _port(model, flat=False,
                                                       **kw)
    assert legacy_step.describe == flat_step.describe
    got, gst = _run(legacy_step, params, batches, 2)
    want, wst = _run(flat_step, params, batches, 2)
    assert got == want
    for k, v in gst["read"].items():
        assert torch.equal(v, wst["read"][k]), k


def test_model_path_bit_exact_vs_backend_path(port_model):
    """``make_step``'s decoupled step on the global batch against
    ``make_backend("prod")`` on the same rows in the sim layout, M=4, the
    backend's shift draws: every metric and the read plane, bit for bit."""
    model, params = port_model
    M = 4
    batches = _batches(model.cfg.vocab_size, M * B)
    kw = dict(fb_ratio=2, update_delay=1, use_pallas=True)
    be = make_backend("prod", "layup", M=M, loss_fn=model.loss_fn,
                      optimizer=momentum(0.9), schedule=constant(LR),
                      device="cpu", measure_drift=False, **kw)
    bst = be.init(None, params)
    want = []
    for b in batches:
        sim = {k: v.reshape((M, B) + v.shape[1:]) for k, v in b.items()}
        bst, m = be.step(bst, sim)
        want.append({k: host(m[k]).tolist() for k in STEP_METRICS})
    rng = np.random.default_rng(0xC0FFEE)  # the backend's shift draws
    shift_idx = [int(rng.integers(0, 2)) for _ in batches]
    got, st = _run(_port(model, M=M, **kw), params, batches, M, shift_idx)
    assert got == want
    for k, v in bst["read"].items():
        assert torch.equal(st["read"][k], v), k


@pytest.mark.parametrize("engine_kw", [
    dict(overlap=True), dict(overlap=True, use_pallas=True),
    dict(overlap=True, streams=3, use_pallas=True)],
    ids=["pipeline", "pipeline-fused", "streams3"])
def test_model_pipeline_bit_exact_vs_monolithic(port_model, engine_kw):
    model, params = port_model
    M = 4
    batches = _batches(model.cfg.vocab_size, M * B)
    rng = np.random.default_rng(1)
    shift_idx = [int(rng.integers(0, 2)) for _ in batches]
    mono_kw = {k: v for k, v in engine_kw.items()
               if k not in ("overlap", "streams")}
    want, wst = _run(_port(model, M=M, fb_ratio=2, update_delay=1,
                           **mono_kw), params, batches, M, shift_idx)
    step = _port(model, M=M, fb_ratio=2, update_delay=1, **engine_kw)
    got, gst = _run(step, params, batches, M, shift_idx)
    assert got == want
    for a, b in zip(tree_leaves(gst["read"]), tree_leaves(wst["read"])):
        assert torch.equal(a, b)
    assert ("stream" in step.describe) == ("streams" in engine_kw)


def test_make_step_faults_and_tuning(port_model):
    """``faults=""`` attaches a controller and gives the fault-free bits; a
    crash plan runs through the Model path (``peers_live`` drops while the
    peer is dead); a tuning record picks the engine and its schedule (a
    ``"legacy"`` one too, on the flat plane)."""
    from repro_torch.chaos import ChaosController
    from repro_torch.launch import tuner as TU

    model, params = port_model
    M = 4
    batches = _batches(model.cfg.vocab_size, M * B, n=4)
    kw = dict(M=M, fb_ratio=2, update_delay=1, use_pallas=True)
    want, _ = _run(_port(model, **kw), params, batches, M)
    step = _port(model, faults="", **kw)
    assert isinstance(step.chaos, ChaosController)
    got, st = _run(step, params, batches, M)
    assert got == want and "alive" in st
    crash = _port(model, faults="crash:peer=1,step=1,recover=3", **kw)
    st = crash.init_state(_stack(params, M))
    live = []
    for t, b in enumerate(batches):
        st, b = crash.chaos.before_step(st, b, t)
        st, m = crash.fn(st, b, t, 0)
        live.append(float(m.get("peers_live", M)))
        assert np.isfinite(float(m["loss"]))
    assert min(live) < M and crash.chaos.summary()["faults_injected"] >= 1
    for grouping in ("layer", "legacy"):
        rec = TU.TuningRecord(
            version=TU.TUNING_SCHEMA_VERSION, key="unit",
            best={"R": 2, "D": 1, "grouping": grouping,
                  "max_inflight_steps": 2, "tile": 128}, score=1.0)
        step = _port(model, M=2, tuning=rec)
        eng = step.engine
        assert (eng.R, eng.D, eng.max_inflight_steps) == (2, 1, 2)
        assert "layup decoupled pipeline (M=2" in step.describe
        hist, _ = _run(step, params, batches[:1], 2)
        assert np.isfinite(hist[0]["loss"])


def test_lockstep_pure_mix_and_accum_against_plain(port_model):
    """The lockstep step through the pure ``gossip_mix`` route against the
    plain mix (α·x + β·r against (w·x + w'·r)/(w + w'): within 1e-6 of the
    largest |value|), and ``accum_steps=2`` against the whole batch within
    the reference's tolerances (``test_accum_steps_matches_full_batch``:
    loss 2e-3, parameters 5e-2); DDP's step-0 loss is the mean of the
    lockstep workers' step-0 losses (1e-5)."""
    model, params = port_model
    M = 2
    batches = _batches(model.cfg.vocab_size, M * B)

    def run(**kw):
        step = _port(model, M=M, **kw)
        p, o, w = step.init_state(_stack(params, M))
        losses = []
        for t, b in enumerate(batches):
            p, o, w, loss = step.fn(p, o, w, b, t, 0)
            losses.append(float(loss))
        return losses, p

    plain, p_plain = run()
    pure, p_pure = run(use_pallas=True)
    np.testing.assert_allclose(pure, plain, rtol=1e-6)
    for a, b in zip(tree_leaves(p_pure), tree_leaves(p_plain)):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    accum, p_accum = run(accum_steps=2)
    assert max(abs(a - b) for a, b in zip(accum, plain)) < 2e-3
    assert max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(p_accum), tree_leaves(p_plain))) < 5e-2
    ddp = _port(model, M=M, algo="ddp")
    p, o = ddp.init_state(params)
    _, _, loss0 = ddp.fn(p, o, batches[0], 0)
    assert abs(float(loss0) - plain[0]) <= 1e-5 * abs(plain[0])


def test_init_states_match_abstract_args(port_model):
    """Each factory's ``init_state`` makes what its ``abstract_args``
    describe (``(shape, dtype)`` pairs)."""
    model, params = port_model
    M = 2

    def same(tree, abstract):
        got = [(tuple(t.shape), t.dtype) for t in tree_leaves(tree)]
        want = [a for a in jax.tree.leaves(
            abstract, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
            and isinstance(x[1], torch.dtype))]
        assert got == want

    ddp = _port(model, M=M, algo="ddp")
    p, o = ddp.init_state(params)
    same(p, ddp.abstract_args[0])
    same(o, ddp.abstract_args[1])
    lock = _port(model, M=M)
    p, o, w = lock.init_state(_stack(params, M))
    for got, want in zip((p, o, w), lock.abstract_args[:3]):
        same(got, want)
    dec = _port(model, M=M, fb_ratio=2, update_delay=1)
    st = dec.init_state(_stack(params, M))
    for k in st:
        same(st[k], dec.abstract_args[0][k])
    assert dec.abstract_args[1] == input_specs(
        model.cfg, ShapeConfig("t", S, M * B, "train"))


def test_worker_mesh():
    mesh = WorkerMesh(4, "cpu")
    assert mesh.workers == 4 and mesh.device == "cpu"
    with pytest.raises(ValueError):
        WorkerMesh(0)
    with pytest.raises(TypeError, match="WorkerMesh"):
        make_step(build_model(reduced(get_config(ARCH))), object(),
                  ShapeConfig("t", S, B, "train"), algo="ddp")


# ---------------------------------------------------------------------------
# (e) the reference's ValueError routes
# ---------------------------------------------------------------------------

# (kind, make_step kwargs, match, global batch); tests/test_decoupled_lane
# .py:188 and tests/test_pipeline.py:232-248 first
VALUE_ERRORS = [
    ("train", dict(algo="ddp", fb_ratio=2), "decoupled", B),
    ("train", dict(fb_ratio=2, accum_steps=2), "accum_steps", B),
    ("train", dict(algo="ddp", overlap=True), "decoupled", B),
    ("train", dict(overlap=True, accum_steps=2), "accum_steps", B),
    ("train", dict(streams=2), "overlap=True", B),
    ("train", dict(wire="int8"), "decoupled LayUp lane", B),
    ("train", dict(compensate=0.5), "decoupled LayUp lane", B),
    ("train", dict(faults=""), "decoupled LayUp lane", B),
    ("train", dict(wire="fp8", fb_ratio=2), "unknown wire", B),
    ("train", dict(compensate=-1.0, fb_ratio=2), "compensate", B),
    ("train", dict(fb_ratio=2), "must divide", 3),
    ("train", dict(fb_ratio=2, accum_steps=1, update_delay=1,
                   overlap=True), "must divide", 3),
    ("prefill", dict(fb_ratio=2), "decoupled", B),
    ("decode", dict(update_delay=1), "decoupled", B),
]


@pytest.mark.parametrize("kind,kw,match,batch", VALUE_ERRORS,
                         ids=[f"{c[0]}-{'-'.join(map(str, c[1].items()))}"
                              for c in VALUE_ERRORS])
def test_make_step_value_errors_match_jax(pair, kind, kw, match, batch):
    jm, _, tm, _ = pair
    with pytest.raises(ValueError, match=match):
        jax_make_step(jm, _jax_mesh(), JaxShape("s", S, batch, kind), **kw)
    with pytest.raises(ValueError, match=match):
        make_step(tm, WorkerMesh(1, "cpu"), ShapeConfig("s", S, batch, kind),
                  **kw)


# the reference's flat-only rules (its legacy tree state lacks the options);
# the port has one state layout, so flat=False takes them all
FLAT_ONLY = [dict(fb_ratio=2, wire="int8"), dict(fb_ratio=2, faults=""),
             dict(fb_ratio=2, use_pallas=True),
             dict(overlap=True, streams=2)]


@pytest.mark.parametrize("kw", FLAT_ONLY,
                         ids=["-".join(map(str, c.items())) for c in FLAT_ONLY])
def test_flat_false_takes_the_flat_only_options(pair, kw):
    jm, _, tm, _ = pair
    with pytest.raises(ValueError, match="flat"):
        jax_make_step(jm, _jax_mesh(), JaxShape("s", S, B, "train"),
                      flat=False, **kw)
    legacy = make_step(tm, WorkerMesh(1, "cpu"), ShapeConfig("s", S, B,
                                                             "train"),
                       flat=False, **kw)
    flat = make_step(tm, WorkerMesh(1, "cpu"), ShapeConfig("s", S, B,
                                                           "train"), **kw)
    assert legacy.describe == flat.describe
    engine = getattr(legacy, "engine", None)
    if hasattr(engine, "close"):
        engine.close()
        flat.engine.close()
