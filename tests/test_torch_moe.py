"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the same numpy inputs, and the port's
own mirror of ``tests/test_moe.py``.

Parameters and inputs are drawn with numpy from a seed at the spec tree's
shapes (float32, ``reduced(mixtral-8x7b)``: d 256, 4 experts, top-2, and
qwen3's fan-out on the same width: 16 experts, top-8); the routing alone
also at qwen3's full width (d 2048, 128 experts, top-8). Tolerances (XLA
and PyTorch sum products in different orders): routing (experts chosen,
slots, keep mask) equal; y rtol 1e-5 / atol 1e-6; aux rtol 1e-5; grads
rtol 1e-4 with an atol of 1e-6 of each leaf's largest gradient.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from _torch_parity import torch_cfg  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

Y_TOL = dict(rtol=1e-5, atol=1e-6)
NAMES = ("router", "wi_gate", "wi_up", "wo")


def _jcfg(fanout=False, **kw):
    if fanout:  # qwen3's top-8 on a narrow width
        cfg = jax_reduced(jax_get_config("qwen3-moe-30b-a3b")).with_(
            num_experts=16, experts_per_token=8)
    else:
        cfg = jax_reduced(jax_get_config("mixtral-8x7b"))
    return cfg.with_(**kw) if kw else cfg


def _np_params(jcfg, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s.shape) * s.scale).astype(np.float32)
            for k, s in JM.moe_specs(jcfg).items()}


def _x(jcfg, shape, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape + (jcfg.d_model,)) * scale).astype(
        np.float32)


def _tp(p):
    return {k: torch.from_numpy(v.copy()) for k, v in p.items()}


@pytest.fixture
def jax_groups():
    """Sets the reference's module-level ``GROUPS``; restored after."""
    def set_groups(g):
        JM.GROUPS = g
    try:
        yield set_groups
    finally:
        JM.GROUPS = 1


# (fanout, capacity_factor, groups): ample capacity, drops, qwen3's
# fan-out with and without drops, grouped dispatch with drops
CASES = [(False, 8.0, 1), (False, 1.0, 1), (True, 8.0, 1), (True, 1.25, 1),
         (False, 1.0, 4), (True, 1.0, 4)]


@pytest.mark.parametrize("fanout,cf,groups", CASES, ids=str)
def test_moe_apply_matches_jax(fanout, cf, groups, jax_groups):
    """y, aux and the grads of router, experts and x against ``jax.grad``
    of the reference, on a loss that weights y and aux."""
    jcfg = _jcfg(fanout, capacity_factor=cf)
    cfg = torch_cfg(jcfg)
    p = _np_params(jcfg, seed=1)
    x = _x(jcfg, (2, 32), seed=2)
    dy = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = JM.moe_apply(p, x, jcfg)
        return jnp.sum(y * dy) + 0.37 * aux, (y, aux)

    jax_groups(groups)
    (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))

    tp = {k: v.requires_grad_(True) for k, v in _tp(p).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = TM.moe_apply(tp, tx, cfg, groups=groups)
    tg = torch.autograd.grad((ty * torch.from_numpy(dy)).sum() + 0.37 * taux,
                             [tp[k] for k in NAMES] + [tx])
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **Y_TOL)
    assert taux.dtype == torch.float32
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)
    for name, g, want in zip(NAMES + ("x",), tg,
                             [jg[0][k] for k in NAMES] + [jg[1]]):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("fanout,cf", [(False, 8.0), (False, 1.0),
                                       (True, 1.0)], ids=str)
def test_routing_matches_jax(fanout, cf):
    """The experts chosen (in order), each assignment's slot and the keep
    mask equal the reference's ``_dispatch_group``; the buffers agree."""
    jcfg = _jcfg(fanout, capacity_factor=cf)
    cfg = torch_cfg(jcfg)
    p = _np_params(jcfg, seed=4)
    xt = _x(jcfg, (64,), seed=5, scale=1.0)
    T, E, k = 64, jcfg.num_experts, jcfg.experts_per_token
    C = JM.capacity(T, E, k, cf)
    jbuf, jmeta, jprobs = JM._dispatch_group(
        jnp.asarray(xt), {k_: jnp.asarray(v) for k_, v in p.items()},
        jcfg, C)
    _, safe_e, safe_s, jkeep, jgv, jgi = (np.asarray(a) for a in jmeta)
    tbuf, tmeta, tprobs = TM._dispatch_group(torch.from_numpy(xt), _tp(p),
                                             cfg, C)
    np.testing.assert_array_equal(tmeta.gate_idx.numpy(), jgi)
    np.testing.assert_array_equal(tmeta.keep.numpy(), jkeep)
    if cf < 8.0:
        assert not jkeep.all()  # the case drops
    kept = jkeep
    np.testing.assert_array_equal(tmeta.slot.numpy()[kept],
                                  (safe_e * C + safe_s)[kept])
    assert (tmeta.slot.numpy()[~kept] == E * C).all()
    np.testing.assert_allclose(tmeta.gate_vals.numpy(), jgv, rtol=1e-6)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    # every kept slot's owner is the assignment that fills it
    owner = tmeta.owner.numpy()
    assert (owner[tmeta.slot.numpy()[kept]] == np.flatnonzero(kept)).all()
    assert (owner == T * k).sum() == E * C - kept.sum()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared,drops", [(0.0, (0.0, 0.1)),
                                          (1 / 3, (0.1, 0.4))], ids=str)
def test_routing_matches_jax_at_full_width(dtype, shared, drops):
    """qwen3-moe-30b-a3b's own routing width (d 2048, 128 experts, top-8,
    capacity factor 1.25) on the 512 tokens of one forward slice of the
    card's training step: the experts chosen and the keep mask equal the
    reference's ``_dispatch_group``, and the dropped share lies in
    ``drops``. The rows of xt are independent, or share one direction
    (``shared`` of a common row added to each), as the MLP inputs of one
    layer at random init do; shared rows pick the same experts, so many
    assignments drop. xt holds integers and the router multiples of
    2^-10, so that every product and sum of the logits is exact in float32
    and the logits (ties included) are the same bits under XLA and
    PyTorch whatever order they sum in."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jcfg = jax_get_config("qwen3-moe-30b-a3b").with_(dtype=jdt)
    cfg = torch_cfg(jcfg)
    d, E, k, T = jcfg.d_model, jcfg.num_experts, jcfg.experts_per_token, 512
    rng = np.random.default_rng(11)
    router = (np.round(rng.standard_normal((d, E)) * 0.02 * 2 ** 10)
              / 2 ** 10).astype(np.float32)
    xt = np.round(2 * (shared * rng.standard_normal(d)[None]
                       + rng.standard_normal((T, d)))).astype(np.float32)
    C = JM.capacity(T, E, k, jcfg.capacity_factor)
    _, jmeta, _ = JM._dispatch_group(
        jnp.asarray(xt, jdt), {"router": jnp.asarray(router, jdt)}, jcfg, C)
    tdt = cfg.dtype
    _, tmeta, _ = TM._dispatch_group(
        torch.from_numpy(xt).to(tdt),
        {"router": torch.from_numpy(router).to(tdt)}, cfg, C)
    np.testing.assert_array_equal(tmeta.gate_idx.numpy(),
                                  np.asarray(jmeta[5]))
    jkeep = np.asarray(jmeta[3])
    np.testing.assert_array_equal(tmeta.keep.numpy(), jkeep)
    assert drops[0] <= 1.0 - jkeep.mean() <= drops[1]


def test_ties_go_to_the_lower_expert_index():
    """Equal router columns give equal probabilities: the experts are
    taken lowest index first, as ``jax.lax.top_k`` takes them."""
    jcfg = _jcfg(True)  # 16 experts, top-8
    cfg = torch_cfg(jcfg)
    p = _np_params(jcfg, seed=6)
    # experts 3, 7, 9, 12 share one column; 0, 5, 14 another
    for group in ((3, 7, 9, 12), (0, 5, 14)):
        p["router"][:, list(group)] = p["router"][:, [group[0]]]
    xt = _x(jcfg, (48,), seed=7, scale=1.0)
    C = JM.capacity(48, 16, 8, 1.25)
    _, jmeta, _ = JM._dispatch_group(
        jnp.asarray(xt), {k: jnp.asarray(v) for k, v in p.items()}, jcfg, C)
    _, tmeta, _ = TM._dispatch_group(torch.from_numpy(xt), _tp(p), cfg, C)
    gi = tmeta.gate_idx.numpy()
    np.testing.assert_array_equal(gi, np.asarray(jmeta[5]))
    np.testing.assert_array_equal(tmeta.keep.numpy(), np.asarray(jmeta[3]))
    # tied experts were chosen together, lower index first
    pos = {e: np.argmax(gi == e, axis=1) + 100 * ~(gi == e).any(1)
           for e in (3, 7, 0, 5)}
    both = (pos[3] < 100) & (pos[7] < 100)
    assert both.any() and (pos[3][both] < pos[7][both]).all()
    both = (pos[0] < 100) & (pos[5] < 100)
    assert both.any() and (pos[0][both] < pos[5][both]).all()
    # an all-zero router: every probability 1/E, the first k experts
    p["router"][:] = 0.0
    _, tmeta, _ = TM._dispatch_group(torch.from_numpy(xt), _tp(p), cfg, C)
    assert (tmeta.gate_idx.numpy() == np.arange(8)).all()


def test_moe_specs_match_jax():
    for fanout in (False, True):
        jcfg = _jcfg(fanout)
        tspecs, jspecs = TM.moe_specs(torch_cfg(jcfg), (3,)), \
            JM.moe_specs(jcfg, (3,))
        assert list(tspecs) == list(jspecs)
        for k, js in jspecs.items():
            ts = tspecs[k]
            assert (ts.shape, ts.axes, ts.init) == (js.shape, js.axes,
                                                    js.init), k
            np.testing.assert_allclose(ts.scale, js.scale, rtol=1e-12)


# ---------------------------------------------------------------------------
# the port's own mirror of tests/test_moe.py (port alone)
# ---------------------------------------------------------------------------


def _cfg(**kw):
    base = reduced(get_config("mixtral-8x7b"))
    return base.with_(**kw) if kw else base


def _params(cfg, seed=0):
    from repro_torch.models.layers import init_params
    return init_params(TM.moe_specs(cfg), seed=seed, device="cpu")


def _randn(shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g) * scale


class TestMoE:
    def test_matches_dense_dispatch_with_ample_capacity(self):
        cfg = _cfg(capacity_factor=8.0)  # no drops possible
        p = _params(cfg)
        x = _randn((2, 16, cfg.d_model), 7, 0.5)
        y1, _ = TM.moe_apply(p, x, cfg)
        y2 = TM.moe_apply_dense(p, x, cfg)
        torch.testing.assert_close(y1, y2, rtol=1e-5, atol=1e-6)

    def test_capacity_drops_reduce_output(self):
        cfg = _cfg(capacity_factor=0.25)
        p = _params(cfg)
        x = _randn((2, 16, cfg.d_model), 8, 0.5)
        y, _ = TM.moe_apply(p, x, cfg)
        assert bool(torch.isfinite(y).all())
        yf, _ = TM.moe_apply(p, x, cfg.with_(capacity_factor=8.0))
        assert float(y.abs().sum()) <= float(yf.abs().sum()) + 1e-3
        assert not torch.equal(y, yf)

    def test_aux_loss_uniform_router_is_one(self):
        cfg = _cfg(capacity_factor=8.0)
        p = dict(_params(cfg))
        p["router"] = torch.zeros_like(p["router"])
        x = _randn((4, 64, cfg.d_model), 9)
        _, aux = TM.moe_apply(p, x, cfg)
        # every token picks experts 0 and 1 (ties to the lower index): f
        # is lumpy, P uniform, so aux = E * (1/2 + 1/2)/E = 1
        assert abs(float(aux) - 1.0) < 1e-6

    def test_gates_renormalized(self):
        """Each token's kept gates sum to 1; the output is the gate-weighted
        sum of its experts' outputs (the dense oracle)."""
        cfg = _cfg(capacity_factor=8.0)
        p = _params(cfg)
        x = _randn((1, 8, cfg.d_model), 10)
        C = TM.capacity(8, cfg.num_experts, cfg.experts_per_token, 8.0)
        _, meta, _ = TM._dispatch_group(x[0], p, cfg, C)
        torch.testing.assert_close(meta.gate_vals.sum(-1), torch.ones(8))
        y1, _ = TM.moe_apply(p, x, cfg)
        torch.testing.assert_close(y1, TM.moe_apply_dense(p, x, cfg),
                                   rtol=1e-5, atol=1e-6)

    def test_grads_flow_to_router_and_experts(self):
        cfg = _cfg(capacity_factor=4.0)
        p = {k: v.requires_grad_(True) for k, v in _params(cfg).items()}
        x = _randn((1, 8, cfg.d_model), 11)
        y, aux = TM.moe_apply(p, x, cfg)
        g = torch.autograd.grad((y ** 2).sum() + 0.01 * aux,
                                [p[k] for k in NAMES])
        for k, v in zip(NAMES, g):
            assert float(v.abs().max()) > 0.0, k

    def test_grouped_dispatch_matches_ungrouped(self):
        cfg = _cfg(capacity_factor=8.0)
        p = _params(cfg)
        x = _randn((2, 32, cfg.d_model), 12, 0.5)
        y_flat, aux_flat = TM.moe_apply(p, x, cfg)
        y_grp, aux_grp = TM.moe_apply(p, x, cfg, groups=4)
        torch.testing.assert_close(y_grp, y_flat, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(aux_grp, aux_flat, rtol=1e-6, atol=0)

    def test_grouped_dispatch_grads(self):
        cfg = _cfg(capacity_factor=4.0)
        p = {k: v.requires_grad_(True) for k, v in _params(cfg).items()}
        x = _randn((1, 16, cfg.d_model), 13)
        y, _ = TM.moe_apply(p, x, cfg, groups=4)
        for k, v in zip(NAMES, torch.autograd.grad((y ** 2).sum(),
                                                   [p[k] for k in NAMES])):
            assert bool(torch.isfinite(v).all()), k

    def test_capacity_function(self):
        assert TM.capacity(64, 4, 2, 1.0) == 32
        assert TM.capacity(64, 4, 2, 1.25) == 40
        assert TM.capacity(2, 64, 2, 1.0) == 2  # floor at k
        assert TM.capacity(512, 128, 8, 1.25) == 40  # qwen3's train slice


def test_no_aux_and_uneven_groups():
    """``return_aux=False`` gives a float32 zero and the same y; groups
    that do not divide B·S fall back to one group, as the reference's."""
    cfg = _cfg(capacity_factor=1.0)
    p = _params(cfg)
    x = _randn((1, 10, cfg.d_model), 14)
    y, aux = TM.moe_apply(p, x, cfg)
    y0, aux0 = TM.moe_apply(p, x, cfg, return_aux=False)
    assert torch.equal(y, y0) and aux0.dtype == torch.float32
    assert float(aux0) == 0.0 and float(aux) > 0.0
    y3, aux3 = TM.moe_apply(p, x, cfg, groups=3)
    assert torch.equal(y3, y) and torch.equal(aux3, aux)


def test_runs_are_bit_identical():
    """Two forward and backward runs give the same bits (no atomics on
    any device; on the CPU this pins the arithmetic order)."""
    cfg = reduced(get_config("qwen3-moe-30b-a3b")).with_(
        num_experts=16, experts_per_token=8)
    outs = []
    for _ in range(2):
        p = {k: v.requires_grad_(True) for k, v in _params(cfg, 3).items()}
        x = _randn((2, 24, cfg.d_model), 15).requires_grad_(True)
        y, aux = TM.moe_apply(p, x, cfg)
        g = torch.autograd.grad((y ** 2).sum() + aux,
                                [p[k] for k in NAMES] + [x])
        outs.append((y, aux) + g)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fanout", [False, True], ids=["top2", "top8"])
def test_bf16_moe_apply_matches_jax(fanout):
    """bfloat16, as the configs run: the routing (experts in order and the
    keep mask) equal; the combine of the same expert outputs under the
    same gates bit-identical (a token's k rows summed in choice order, each
    sum rounded to bf16, as the reference's scatter-add rounds); y within
    2e-2 of max |y| (the expert products round to bf16 on both sides, in
    different sum orders); aux rtol 1e-3."""
    jcfg = _jcfg(fanout, capacity_factor=1.25, dtype=jnp.bfloat16)
    cfg = torch_cfg(jcfg)
    p = _np_params(jcfg, seed=8)
    x = _x(jcfg, (2, 32), seed=9, scale=1.0)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    jx = jnp.asarray(x, jnp.bfloat16)
    tp = {k: v.to(torch.bfloat16) for k, v in _tp(p).items()}
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jy, jaux = jax.jit(lambda p, x: JM.moe_apply(p, x, jcfg))(jp, jx)
    ty, taux = TM.moe_apply(tp, tx, cfg)
    assert ty.dtype == torch.bfloat16
    jy = host_f32(jy)
    np.testing.assert_allclose(ty.float().numpy(), jy, rtol=0,
                               atol=2e-2 * np.abs(jy).max())
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-3)

    T, E, k = 64, jcfg.num_experts, jcfg.experts_per_token
    C = JM.capacity(T, E, k, 1.25)
    jbuf, jmeta, _ = JM._dispatch_group(jx.reshape(T, -1), jp, jcfg, C)
    _, tmeta, _ = TM._dispatch_group(tx.reshape(T, -1), tp, cfg, C)
    np.testing.assert_array_equal(tmeta.gate_idx.numpy(),
                                  np.asarray(jmeta[5]))
    np.testing.assert_array_equal(tmeta.keep.numpy(), np.asarray(jmeta[3]))
    jout = JM._expert_ffn(jp, jbuf)
    want = JM._combine_group(jout, jmeta, T, jcfg.d_model, jnp.bfloat16)
    got = TM._combine_group(
        torch.from_numpy(host_f32(jout)).to(torch.bfloat16),
        tmeta._replace(gate_vals=torch.from_numpy(np.asarray(jmeta[4]))),
        T, cfg.d_model, torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), host_f32(want))


def host_f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))
