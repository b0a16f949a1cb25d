"""Shared pieces of the port's training parity tests: the MLP fixture's
loss in PyTorch and the comparisons with their tolerances.

Tolerances (float32 on the CPU; XLA and PyTorch order the sums of matrix
products differently, so the two drift apart by rounding only): loss and
metrics rtol 1e-5; planes rtol 1e-5 (MLP) / 1e-4 (decoder) with atol 1e-6.

``run_port`` and ``assert_runs_equal`` hold one run of the port's prod
backend to another bit for bit (the engines against the monolithic step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _fixtures import mlp_batch, mlp_problem

METRICS = ("loss", "update_staleness", "layer_staleness", "weight_sum",
           "disagreement", "staleness_mean")


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_cfg(jcfg):
    """The port's ModelConfig of a JAX package's config, field for field."""
    from repro_torch.configs.base import ModelConfig

    kw = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    kw["dtype"] = _TORCH_DTYPES[np.dtype(jcfg.dtype).name]
    return ModelConfig(**kw)


def model_pair(name, seed=0, **kw):
    """(jax model, jax params, port model, port params) of one JAX init of
    ``reduced(name)`` (with ``kw``), carried across with ``to_torch``."""
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced as jax_reduced
    from repro.models import build_model as jax_build_model
    from repro_torch.convert import to_torch
    from repro_torch.models import build_model

    jcfg = jax_reduced(jax_get_config(name))
    if kw:
        jcfg = jcfg.with_(**kw)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(torch_cfg(jcfg))
    return jm, jp, tm, to_torch(jax.tree.map(np.asarray, jp), "cpu")


def assert_tree_close(ttree, jtree, what, **tol):
    """Every leaf of a JAX tree (a cache) against the port's leaf at the
    same path, in float32."""
    for path, w in jax.tree.flatten_with_path(jtree)[0]:
        g = ttree
        for e in path:
            g = g[e.key]
        np.testing.assert_allclose(
            g.detach().float().cpu().numpy(),
            np.asarray(jnp.asarray(w, jnp.float32)), **tol,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def torch_mlp_loss(p, b):
    h = torch.tanh(b["x"] @ p["l1"])
    logits = h @ p["l2"]
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.mean(logp[torch.arange(logits.shape[0]), b["labels"].long()])
    return ce, {}


_jnp_repeat = jnp.repeat


def repeat_without_sharding(a, repeats, axis=None, **kw):
    """``jnp.repeat`` for the reference's prod step. Under jax 0.9 that
    step traces its loss inside a ``shard_map`` with explicit mesh axes,
    where ``jnp.repeat`` with ``axis=None`` raises for want of
    ``out_sharding``; its MoE dispatch calls ``jnp.repeat(jnp.arange(Tg),
    k)`` (ROADMAP queue 3, Ref-4). The same values through
    ``broadcast_to``: a 1-D array, each element ``repeats`` times in order;
    any other call goes to the real ``jnp.repeat``."""
    if axis is None and jnp.ndim(a) == 1 and isinstance(repeats, int) \
            and not kw:
        return jnp.broadcast_to(a[:, None], (a.shape[0], repeats)).reshape(-1)
    return _jnp_repeat(a, repeats, axis=axis, **kw)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def compare_metrics(tm, jm, t, rtol=1e-5):
    for k in METRICS:
        np.testing.assert_allclose(host(tm[k]), np.asarray(jm[k]),
                                   rtol=rtol, atol=1e-7,
                                   err_msg=f"{k} at step {t}")


def compare_planes(tplane, jplane, rtol):
    assert list(tplane) == list(jplane)
    for k in jplane:
        np.testing.assert_allclose(host(tplane[k]), np.asarray(jplane[k]),
                                   rtol=rtol, atol=1e-6, err_msg=k)


STEP_METRICS = ("loss", "update_staleness", "layer_staleness",
                "weight_sum", "disagreement", "staleness_mean")


def mlp_params():
    return np_tree(mlp_problem()[1])


def materialize(be, tree):
    """A state tree of the backend's engine as tensors."""
    eng = be.engine
    return eng.materialize(tree) if hasattr(eng, "materialize") else tree


def run_port(M, R, D, steps=5, **kw):
    """``(histories, planes, summary, backend)`` of the port's prod backend
    on the MLP fixture (CPU): host copies of each step's metrics and of the
    final read plane (and residual, θ where present). The stream engine's
    threads are closed before it returns."""
    from repro_torch.core.backend import make_backend
    from repro_torch.optim import constant, momentum

    be = make_backend("prod", "layup", M=M, loss_fn=torch_mlp_loss,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      fb_ratio=R, update_delay=D, device="cpu",
                      wait_timeout_s=20.0, **kw)
    try:
        st = be.init(None, mlp_params())
        hist = []
        for t in range(steps):
            st, m = be.step(st, np_tree(mlp_batch(t, M=M, b=4 * R)))
            hist.append(m)
        hist = [{k: np.asarray(m[k]) for k in STEP_METRICS} for m in hist]
        planes = {name: {k: v.clone() for k, v in
                         materialize(be, st[name]).items()}
                  for name in ("read", "resid", "theta") if name in st}
        summary = be.summary()
    finally:
        if hasattr(be.engine, "close"):
            be.engine.close()
    return hist, planes, summary, be


def assert_runs_equal(got, want):
    """Two ``run_port`` results bit for bit: every metric of every step,
    and every final plane."""
    for t, (g, w) in enumerate(zip(got[0], want[0])):
        for k in STEP_METRICS:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{k} @ {t}")
    assert list(got[1]) == list(want[1])
    for name in want[1]:
        for k in want[1][name]:
            assert torch.equal(got[1][name][k], want[1][name][k]), (name, k)


# ---------------------------------------------------------------------------
# the sim trainer against the JAX package's, step by step
# ---------------------------------------------------------------------------

SIM_METRICS = ("loss", "weight_sum", "update_staleness", "layer_staleness",
               "staleness_mean", "disagreement", "lr")
ALGO_METRICS = ("gossip_sends", "pairs", "synced")


def inject_jax_draws(monkeypatch):
    """Replace the port's two random draws (``api.draw_peers``,
    ``adpsgd.draw_permutation``) by the JAX draws a test sets for the step
    in the returned dict (``"peers"``, ``"perm"``)."""
    from repro_torch.core import adpsgd, api

    cur = {}
    monkeypatch.setattr(api, "draw_peers",
                        lambda rng, M, device: cur["peers"].to(device))
    monkeypatch.setattr(adpsgd, "draw_permutation",
                        lambda rng, M, device: cur["perm"].to(device))
    return cur


def jax_draws(cur, r, M):
    """The draws the JAX sim step makes from its step key ``r``: its hooks
    get ``r1 = split(r)[0]``."""
    r1 = jax.random.split(r)[0]
    cur["peers"] = torch.from_numpy(np.asarray(
        jax.random.randint(r1, (M,), 0, M - 1)).astype(np.int64))
    cur["perm"] = torch.from_numpy(np.asarray(
        jax.random.permutation(r1, M)).astype(np.int64))


def pack_np(part, tree):
    """A numpy tree (stacked or single) packed into the port's plane."""
    return part.pack(jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                  tree))


def compare_sim_metrics(tm, jm, t, rtol=1e-5):
    for k in SIM_METRICS + ALGO_METRICS:
        if k not in jm:
            assert k not in tm, k
            continue
        np.testing.assert_allclose(host(tm[k]), np.asarray(jm[k]),
                                   rtol=rtol, atol=1e-6,
                                   err_msg=f"{k} at step {t}")


def compare_sim_state(be, ts, js, rtol, atol=1e-6):
    """Planes, weights, version clocks and the algorithm's extras."""
    part = be.part
    compare_planes(ts.params, pack_np(part, js.params), rtol)
    np.testing.assert_allclose(host(ts.weights), np.asarray(js.weights),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(host(ts.versions), np.asarray(js.versions))
    jx, tx = js.extras, ts.extras
    if isinstance(jx, dict) and "q0" in jx:  # the block-mode queue
        for q in ("q0", "q1"):
            compare_planes(tx[q]["vals"], pack_np(part, jx[q]["vals"]), rtol)
            np.testing.assert_allclose(host(tx[q]["w"]),
                                       np.asarray(jx[q]["w"]), rtol=1e-6)
            np.testing.assert_array_equal(host(tx[q]["valid"]),
                                          np.asarray(jx[q]["valid"]))
            assert float(tx[q]["stamp"]) == float(jx[q]["stamp"])
    elif isinstance(jx, dict):  # SlowMo / CO2 single-worker buffers
        assert sorted(tx) == sorted(jx)
        for k in jx:
            compare_planes(tx[k], pack_np(part, jx[k]), rtol)
    else:
        assert tx == () and jx == ()


def run_sim_pair(monkeypatch, algo, M, R, D, *, jloss, tloss, params,
                 batch_fn, steps=5, lr=0.05, rtol=1e-5, algo_kw=None,
                 straggler_delays=None):
    """The JAX sim trainer and the port's sim backend (CPU) on the same
    numpy inputs and the same random draws, compared after every step:
    metrics, then the final planes, weights, clocks and extras. Returns
    the port's backend, state and metrics history."""
    from repro.core import get_algorithm as jax_get_algorithm
    from repro.core import make_sim_trainer as jax_make_sim_trainer
    from repro.optim import constant as jax_constant
    from repro.optim import momentum as jax_momentum
    from repro_torch.core.backend import make_backend
    from repro_torch.optim import constant, momentum

    algo_kw = algo_kw or {}
    kw = dict(fb_ratio=R, update_delay=D, straggler_delays=straggler_delays)
    jinit, jstep = jax_make_sim_trainer(
        jax_get_algorithm(algo, **algo_kw), jloss, jax_momentum(0.9),
        jax_constant(lr), M, **kw)
    from repro_torch.core.api import get_algorithm
    be = make_backend("sim", get_algorithm(algo, **algo_kw), M=M,
                      loss_fn=tloss, optimizer=momentum(0.9),
                      schedule=constant(lr), device="cpu", **kw)
    cur = inject_jax_draws(monkeypatch)
    js = jinit(jax.random.PRNGKey(0), params)
    ts = be.init(0, np_tree(params))
    rng = jax.random.PRNGKey(2)
    hist = []
    for t in range(steps):
        b = np_tree(batch_fn(t))
        rng, r = jax.random.split(rng)
        jax_draws(cur, r, M)
        js, jm = jstep(js, jax.tree.map(jax.numpy.asarray, b), r)
        ts, tm = be.step(ts, b)
        compare_sim_metrics(tm, jm, t)
        hist.append(tm)
    compare_sim_state(be, ts, js, rtol)
    return be, ts, hist
