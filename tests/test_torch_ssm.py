"""The port's SSM family (``models/ssm.py``, the SSM decoder, Mamba2-780M)
against the JAX package's, on the same numpy inputs, and inside the port
(chunked form against its recurrence, state chaining), as
``tests/test_ssm.py`` pins them inside JAX.

Parameters come from one JAX init carried across with
``repro_torch.convert``. Tolerances, float32 on the CPU (XLA and PyTorch
order the sums of products and scans differently): the SSD functions and
the block rtol 1e-5 / atol 1e-6 against JAX, the chunked form against the
recurrence rtol 1e-4 / atol 1e-5 (as ``tests/test_ssm.py``); the decoder's
loss rtol 1e-5 and grads rtol 1e-4 with an atol of 1e-4 of each leaf's
largest gradient; the prod step's metrics rtol 1e-5 and planes rtol 1e-4
(``_torch_parity.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import compare_metrics, compare_planes, np_tree  # noqa: E402,E501
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced  # noqa: E402
from repro.core.backend import make_backend as jax_make_backend  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as JLy  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro.optim import momentum as jax_momentum  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core.backend import make_backend  # noqa: E402
from repro_torch.core.pytree import (tree_flatten_with_path,  # noqa: E402
                                     tree_leaves)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.transformer import decoder_specs  # noqa: E402
from repro_torch.optim import constant, momentum  # noqa: E402

JAX_TOL = dict(rtol=1e-5, atol=1e-6)
REC_TOL = dict(rtol=1e-4, atol=1e-5)


def _torch_cfg(jcfg, dtype=torch.float32):
    kw = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    kw["dtype"] = dtype
    return ModelConfig(**kw)


def _ssd_inputs(seed, b=2, l=32, h=3, p=8, n=4):
    """x, dt, A, Bm, Cm as float32 numpy arrays (test_ssm.py's
    distributions)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return ((rng.standard_normal((b, l, h, p)) * 0.5).astype(f),
            np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(f),
            -np.exp(rng.standard_normal(h) * 0.3).astype(f),
            (rng.standard_normal((b, l, n)) * 0.5).astype(f),
            (rng.standard_normal((b, l, n)) * 0.5).astype(f))


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol=JAX_TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# the SSD functions against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_matches_jax(with_init):
    ins = _ssd_inputs(1)
    init = (np.random.default_rng(2).standard_normal((2, 3, 4, 8))
            .astype(np.float32) if with_init else None)
    jy, js = JS.ssd_chunked(*_j(ins), chunk=8, init_state=None if init is
                            None else jnp.asarray(init))
    ty, ts = TS.ssd_chunked(*_t(ins), chunk=8, init_state=None if init is
                            None else torch.from_numpy(init))
    _close(ty, jy, msg="y")
    _close(ts, js, msg="final state")


def test_ssd_recurrent_step_and_reference_match_jax():
    x, dt, A, Bm, Cm = ins = _ssd_inputs(3, l=12)
    state = np.random.default_rng(4).standard_normal((2, 3, 4, 8)).astype(
        np.float32)
    jy, jn = JS.ssd_recurrent_step(jnp.asarray(state),
                                   *_j((x[:, 0], dt[:, 0], A, Bm[:, 0],
                                        Cm[:, 0])))
    ty, tn = TS.ssd_recurrent_step(torch.from_numpy(state),
                                   *_t((x[:, 0], dt[:, 0], A, Bm[:, 0],
                                        Cm[:, 0])))
    _close(ty, jy, msg="step y")
    _close(tn, jn, msg="step state")
    jy, js = JS.ssd_reference(*_j(ins), init_state=jnp.asarray(state))
    ty, ts = TS.ssd_reference(*_t(ins), init_state=torch.from_numpy(state))
    _close(ty, jy, msg="reference y")
    _close(ts, js, msg="reference state")


def test_conv_causal_with_tail_matches_jax():
    rng = np.random.default_rng(5)
    xbc, w, b, tail = (rng.standard_normal(s).astype(np.float32) for s in
                       ((2, 9, 6), (4, 6), (6,), (2, 3, 6)))
    for t in (None, tail):
        jo, jt = JS._conv_causal(*_j((xbc, w, b)), None if t is None
                                 else jnp.asarray(t))
        to, tt = TS._conv_causal(*_t((xbc, w, b)), None if t is None
                                 else torch.from_numpy(t))
        _close(to, jo, msg="conv out")
        _close(tt, jt, msg="new tail")


@pytest.fixture(scope="module")
def reduced_cfg():
    return reduced(jax_get_config("mamba2-780m"))


def test_ssm_block_apply_matches_jax(reduced_cfg):
    """One block with JAX-initialised params (gate norm, D skip, conv):
    the output, the final state and the conv tail, at chunk 4 (four
    chunks)."""
    jcfg = reduced_cfg
    jp = JLy.init_params(jax.random.PRNGKey(0), JS.ssm_specs(jcfg))
    x = (np.random.default_rng(6).standard_normal((2, 16, jcfg.d_model))
         * 0.1).astype(np.float32)
    jout, (jst, jtail) = JS.ssm_block_apply(jp, jnp.asarray(x), jcfg,
                                            return_state=True, chunk=4)
    tp = to_torch(jax.tree.map(np.asarray, jp), "cpu")
    tout, (tst, ttail) = TS.ssm_block_apply(tp, torch.from_numpy(x),
                                            _torch_cfg(jcfg),
                                            return_state=True, chunk=4)
    _close(tout, jout, msg="block out")
    _close(tst, jst, msg="block state")
    _close(ttail, jtail, msg="block conv tail")


# ---------------------------------------------------------------------------
# inside the port: chunked against recurrent, state chaining
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_port_chunked_matches_its_recurrence(chunk):
    ins = _t(_ssd_inputs(7))
    y1, s1 = TS.ssd_chunked(*ins, chunk=chunk)
    y2, s2 = TS.ssd_reference(*ins)
    _close(y1, y2, REC_TOL, "y")
    _close(s1, s2, REC_TOL, "state")


def test_port_state_chains_over_two_halves():
    """[0:L/2) then [L/2:L) with the carried state == the full run."""
    x, dt, A, Bm, Cm = _t(_ssd_inputs(8))
    y_full, s_full = TS.ssd_chunked(x, dt, A, Bm, Cm, chunk=8)
    y1, s1 = TS.ssd_chunked(x[:, :16], dt[:, :16], A, Bm[:, :16],
                            Cm[:, :16], chunk=8)
    y2, s2 = TS.ssd_chunked(x[:, 16:], dt[:, 16:], A, Bm[:, 16:],
                            Cm[:, 16:], chunk=8, init_state=s1)
    _close(torch.cat([y1, y2], 1), y_full, REC_TOL, "y")
    _close(s2, s_full, REC_TOL, "state")


def test_ssd_chunked_gradients_stay_finite_past_exp_overflow():
    """A full chunk of large decays: cum_i − cum_j above the diagonal
    passes log(f32 max); the masked exponential keeps the grads finite."""
    x, dt, A, Bm, Cm = _t(_ssd_inputs(9, b=1, l=128, h=2, p=4, n=4))
    dt = (dt + 1.0).requires_grad_(True)
    y, _ = TS.ssd_chunked(x, dt, A * 4, Bm, Cm, chunk=128)
    (g,) = torch.autograd.grad(y.square().sum(), dt)
    assert torch.isfinite(g).all()


def _jax_sequential(x, dt, A, Bm, Cm):
    """The JAX package's ``ssd_reference`` as one ``lax.scan`` over its
    ``ssd_recurrent_step`` (the same steps in the same order; the Python
    loop of 128 steps takes minutes to differentiate under jit)."""
    state = jnp.zeros((x.shape[0], x.shape[2], Bm.shape[-1], x.shape[3]),
                      jnp.float32)

    def body(state, t):
        x_t, dt_t, B_t, C_t = t
        y, state = JS.ssd_recurrent_step(state, x_t, dt_t, A, B_t, C_t)
        return state, y

    state, ys = jax.lax.scan(body, state, tuple(
        jnp.moveaxis(a, 1, 0) for a in (x, dt, Bm, Cm)))
    return jnp.moveaxis(ys, 0, 1), state


def test_ssd_chunked_gradients_match_jax_sequential_past_exp_overflow():
    """The same full chunk of 128 with overflowing decays (the chunk the
    Mamba2 step trains at; |cum| reaches hundreds): the port's chunked y,
    final state and grads for every input against the JAX package's
    sequential recurrence and ``jax.grad`` of it, which take no
    exponential of a positive difference."""
    x, dt, A, Bm, Cm = _ssd_inputs(9, b=1, l=128, h=2, p=4, n=4)
    ins = (x, dt + np.float32(1.0), A * np.float32(4.0), Bm, Cm)
    rng = np.random.default_rng(10)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    gs = rng.standard_normal((1, 2, 4, 4)).astype(np.float32)

    def jloss(*a):
        y, s = _jax_sequential(*a)
        return jnp.sum(y * gy) + jnp.sum(s * gs), (y, s)

    jg, (jy, js) = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4),
                                    has_aux=True))(*_j(ins))
    targs = [t.requires_grad_(True) for t in _t(ins)]
    y, s = TS.ssd_chunked(*targs, chunk=128)
    tg = torch.autograd.grad((y * torch.from_numpy(gy)).sum()
                             + (s * torch.from_numpy(gs)).sum(), targs)
    _close(y.detach(), jy, REC_TOL, "y")
    _close(s.detach(), js, REC_TOL, "state")
    for name, got, want in zip(("x", "dt", "A", "Bm", "Cm"), tg, jg):
        _close(got, want, REC_TOL, f"d{name}")


# ---------------------------------------------------------------------------
# the SSM decoder: reduced(mamba2-780m) against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def problem(reduced_cfg):
    jmodel = jax_build_model(reduced_cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    toks = rng.integers(0, reduced_cfg.vocab_size, (2, 257)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return reduced_cfg, jmodel, jparams, batch


def _torch_loss(problem, seq, grads):
    jcfg, _, jparams, batch = problem
    model = build_model(_torch_cfg(jcfg))
    tparams = to_torch(jax.tree.map(np.asarray, jparams), "cpu")
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(grads)
    tb = to_torch({k: v[:, :seq] for k, v in batch.items()}, "cpu")
    tloss, aux = model.loss_fn(tparams, tb)
    assert float(aux["aux"]) == 0.0
    return tloss, (torch.autograd.grad(tloss, leaves) if grads else None)


def test_reduced_decoder_specs_match_jax(reduced_cfg):
    """The tree (paths, shapes, axes, init kinds, scales): an SSM sublayer
    followed by an MLP sublayer (the reduced config keeps d_ff=512)."""
    from repro.models.transformer import decoder_specs as jax_specs
    _check_specs(decoder_specs(_torch_cfg(reduced_cfg)),
                 jax_specs(reduced_cfg))


def _check_specs(tspecs, jspecs):
    tflat, _ = tree_flatten_with_path(tspecs)
    jflat, _ = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda s: isinstance(s, JLy.ParamSpec))
    assert [[e.key for e in p] for p, _ in tflat] == \
        [[e.key for e in p] for p, _ in jflat]
    for (_, ts), (_, js) in zip(tflat, jflat):
        assert (ts.shape, ts.axes, ts.init) == (js.shape, js.axes, js.init)
        np.testing.assert_allclose(ts.scale, js.scale, rtol=1e-12)


def test_reduced_decoder_loss_matches_jax_over_two_chunks(problem):
    """S=256: two chunks of 128 in every SSM layer, forward only (the
    reference's gradient is NaN there, see the next test)."""
    jcfg, jmodel, jparams, batch = problem
    jloss, _ = jax.jit(jmodel.loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, _ = _torch_loss(problem, 256, grads=False)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)


def test_reduced_decoder_loss_and_grads_match_jax(problem):
    """S=64, one chunk. (A full chunk of 128 at these step sizes overflows
    the reference's unmasked exp(cum_i − cum_j) above the diagonal, whose
    gradient is then 0·inf = NaN; the port takes the exponential where
    i >= j only.)"""
    jcfg, jmodel, jparams, batch = problem
    jb = {k: jnp.asarray(v[:, :64]) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jb), has_aux=True))(jparams)
    tloss, tgrads = _torch_loss(problem, 64, grads=True)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(tgrads)
    for tg, jg in zip(tgrads, jleaves):
        jg = np.asarray(jg)
        np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-4,
                                   atol=1e-4 * np.abs(jg).max())


@pytest.mark.parametrize("R,D", [(1, 0), (2, 1)])
def test_m1_prod_step_matches_jax(problem, R, D):
    """The prod step (M=1, ``use_pallas=True``) on reduced(mamba2-780m):
    metrics and read plane per step, 2 steps on sequences of 16."""
    jcfg, jmodel, jparams, _ = problem
    kw = dict(M=1, fb_ratio=R, update_delay=D, use_pallas=True)
    jbe = jax_make_backend("prod", "layup", loss_fn=jmodel.loss_fn,
                           optimizer=jax_momentum(0.9),
                           schedule=jax_constant(0.05), **kw)
    tbe = make_backend("prod", "layup",
                       loss_fn=build_model(_torch_cfg(jcfg)).loss_fn,
                       optimizer=momentum(0.9), schedule=constant(0.05),
                       device="cpu", **kw)
    js = jbe.init(jax.random.PRNGKey(0), jparams)
    ts = tbe.init(None, np_tree(jparams))
    rng = np.random.default_rng(12)
    for t in range(2):
        toks = rng.integers(0, jcfg.vocab_size, (1, 4, 17)).astype(np.int32)
        b = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        js, jm = jbe.step(js, jax.tree.map(jnp.asarray, b),
                          jax.random.PRNGKey(t))
        ts, tm = tbe.step(ts, b, None)
        compare_metrics(tm, jm, t)
        compare_planes(ts["read"], js["read"], rtol=1e-4)


# ---------------------------------------------------------------------------
# the full config; bfloat16
# ---------------------------------------------------------------------------


def test_full_config_specs_and_param_counts_match_jax():
    """Mamba2-780M at full width and depth, from specs alone (nothing is
    allocated): the config's fields, the spec tree and ``param_counts``."""
    from repro.models.transformer import decoder_specs as jax_specs
    t, j = get_config("mamba2-780m"), jax_get_config("mamba2-780m")
    for f in j.__dataclass_fields__:
        if f != "dtype":
            assert getattr(t, f) == getattr(j, f), f
    assert t.dtype == torch.bfloat16 and jnp.dtype(j.dtype).name == "bfloat16"
    assert t.param_counts() == j.param_counts()
    _check_specs(decoder_specs(t), jax_specs(j))
    n = sum(int(np.prod(s.shape)) for _, s in
            tree_flatten_with_path(decoder_specs(t))[0])
    assert 7.7e8 < n < 7.9e8


def test_bf16_reduced_prod_step_runs_finite(reduced_cfg):
    """The port's own bfloat16 model (random init) through the prod step at
    M=2: losses near ln(V), finite planes, Σw = 1."""
    cfg = _torch_cfg(reduced_cfg, torch.bfloat16)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    assert params["blocks"]["sub0"]["ssm"]["in_proj_x"].dtype == \
        torch.bfloat16
    be = make_backend("prod", "layup", M=2, loss_fn=model.loss_fn,
                      optimizer=momentum(0.9), schedule=constant(3e-3),
                      fb_ratio=2, update_delay=1, use_pallas=True,
                      device="cpu")
    st = be.init(None, params)
    rng = np.random.default_rng(13)
    for t in range(2):
        toks = rng.integers(0, cfg.vocab_size, (2, 2, 33))
        st, m = be.step(st, {"tokens": toks[..., :-1],
                             "labels": toks[..., 1:]})
        assert abs(float(m["loss"]) - np.log(cfg.vocab_size)) < 0.5
        assert abs(float(m["weight_sum"]) - 1.0) <= 1e-5
        assert float(m["nonfinite_skips"]) == 0.0
    for g, v in st["read"].items():
        assert v.dtype == torch.bfloat16 and torch.isfinite(v).all(), g
