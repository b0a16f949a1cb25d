"""The port's MoE family (mixtral-8x7b, moonshot-v1-16b-a3b and
qwen3-moe-30b-a3b with ``qk_norm``) against the JAX package's, at the
reduced sizes of ``configs.base.reduced``: the decoder spec tree, the loss
with its ``ce`` and ``aux`` and the grads, ``prefill_fn`` and ``decode_fn``,
the incremental decode against the full forward, and the prod training
step at M=1 (the M=2 case runs in ``test_torch_train_multiworker.py``).
Inside the port, the pipeline engine is bit-exact with the monolithic step
on ``reduced(qwen3-moe-30b-a3b)``.

Parameters come from one JAX init carried across with
``repro_torch.convert``; tokens are drawn with numpy. Tolerances (float32
on the CPU; XLA and PyTorch sum products in different orders): loss, ce
and aux rtol 1e-5; grads rtol 1e-4 with an atol of 1e-4 of each leaf's
largest gradient (``test_torch_model.py``'s decoder tolerance); logits and
caches rtol 1e-4 / atol 1e-5 (``test_torch_decode.py``'s); the prod step's
metrics rtol 1e-5 and plane rtol 1e-4 (``_torch_parity.py``'s).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import (assert_runs_equal, assert_tree_close,  # noqa: E402,E501
                           compare_metrics, compare_planes, materialize,
                           model_pair, np_tree, repeat_without_sharding,
                           torch_cfg)
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.backend import make_backend as jax_make_backend  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.transformer import decoder_specs as jax_specs  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro.optim import momentum as jax_momentum  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.backend import make_backend  # noqa: E402
from repro_torch.core.pytree import (tree_flatten_with_path,  # noqa: E402
                                     tree_leaves)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import constant, momentum  # noqa: E402

MOE = ["mixtral-8x7b", "moonshot-v1-16b-a3b", "qwen3-moe-30b-a3b"]
STEP_TOL = dict(rtol=1e-4, atol=1e-5)


def host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _batch(vocab, B, S, seed):
    toks = _tokens(vocab, B, S + 1, seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("name", MOE)
def test_decoder_specs_match_reference_tree(name):
    """Paths, shapes, axes, init kinds and scales of the reduced and the
    full config (nothing is allocated); the reduced configs equal the JAX
    package's ``reduced`` field for field."""
    jr = jax_reduced(jax_get_config(name))
    tr = reduced(get_config(name))
    assert tr == torch_cfg(jr)
    for tcfg, jcfg in ((tr, jr), (get_config(name), jax_get_config(name))):
        tflat, _ = tree_flatten_with_path(T.decoder_specs(tcfg))
        jflat, _ = jax.tree_util.tree_flatten_with_path(
            jax_specs(jcfg), is_leaf=lambda s: isinstance(s, JL.ParamSpec))
        assert [[e.key for e in p] for p, _ in tflat] == \
            [[e.key for e in p] for p, _ in jflat]
        for (_, ts), (_, js) in zip(tflat, jflat):
            assert (ts.shape, ts.axes, ts.init) == (js.shape, js.axes,
                                                    js.init)
            np.testing.assert_allclose(ts.scale, js.scale, rtol=1e-12)
    mlp = T.decoder_specs(tr)["blocks"]["sub0"]["mlp"]
    assert set(mlp) == {"norm", "router", "wi_gate", "wi_up", "wo"}
    attn = T.decoder_specs(tr)["blocks"]["sub0"]["attn"]
    assert ("q_norm" in attn) == (name == "qwen3-moe-30b-a3b")


@pytest.mark.parametrize("name", MOE)
def test_loss_ce_aux_and_grads_match_jax(name):
    jm, jp, tm, tp = model_pair(name)
    batch = _batch(jm.cfg.vocab_size, 2, 16, seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jb, block_k=8), has_aux=True))(jp)

    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tloss, tmet = tm.loss_fn(tp, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, leaves)
    assert set(tmet) == {"ce", "aux"}
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for k in ("ce", "aux"):
        assert tmet[k].dtype == torch.float32
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    assert tmet["aux"].item() > 1.0  # two MoE layers, each near 1
    np.testing.assert_allclose(
        tloss.item(), float(tmet["ce"] + tm.cfg.router_aux_weight
                            * tmet["aux"]), rtol=1e-6)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(tgrads)
    for tg, jg in zip(tgrads, jleaves):
        jg = np.asarray(jg)
        np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-4,
                                   atol=1e-4 * np.abs(jg).max())


@pytest.mark.parametrize("name", ["mixtral-8x7b", "qwen3-moe-30b-a3b"])
def test_decode_fn_and_prefill_fn_match_jax(name):
    """``decode_fn`` step by step (each sequence at its own position) and
    ``prefill_fn``, logits and caches, against the JAX package's."""
    jm, jp, tm, tp = model_pair(name)
    B, S = 2, 20
    toks = _tokens(jm.cfg.vocab_size, B, S, 4)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jm.cache_specs(B, S))
    tcache = T.alloc_cache(tm.cache_specs(B, S), device="cpu")
    jstep = jax.jit(jm.decode_fn)
    for t in range(S):
        pos = np.asarray([t, max(t - 1, 0)], np.int32)
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.asarray(pos))
        tl, tcache = tm.decode_fn(tp, tcache,
                                  torch.from_numpy(toks[:, t:t + 1]),
                                  torch.from_numpy(pos).long())
        np.testing.assert_allclose(host(tl), host(jl), **STEP_TOL,
                                   err_msg=f"{name} logits at step {t}")
    assert_tree_close(tcache, jcache, f"{name} cache", **STEP_TOL)
    jc, jlog = jm.prefill_fn(jp, {"tokens": jnp.asarray(toks)}, block_k=8)
    tc, tlog = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(host(tlog), host(jlog), **STEP_TOL)
    assert_tree_close(tc, jc, f"{name} prefill cache", **STEP_TOL)


@pytest.mark.parametrize("name", MOE)
def test_incremental_decode_matches_full_forward(name):
    """As ``tests/test_decode_consistency.py``: at ``capacity_factor=8``
    nothing drops, so the one-token steps reproduce the full forward's
    logits at every position (mixtral's window of 16 over a ring of 16
    slots at S=24)."""
    _, _, tm, tp = model_pair(name, seed=7, capacity_factor=8.0)
    cfg = tm.cfg
    B, S = 2, 24
    toks = torch.from_numpy(_tokens(cfg.vocab_size, B, S, 8))
    with torch.no_grad():
        h = TL.embed_apply(tp["embed"], toks)
        pos = torch.arange(S)[None].expand(B, S)
        h, _, _ = T.decoder_forward(tp, h, cfg, positions=pos)
        full = TL.unembed_apply(
            tp["embed"], TL.rmsnorm(h, tp["final_norm"], cfg.norm_eps),
            cfg.tie_embeddings)
    cache = T.alloc_cache(tm.cache_specs(B, S), device="cpu")
    for t in range(S):
        logits, cache = tm.decode_fn(tp, cache, toks[:, t:t + 1],
                                     torch.full((B,), t))
        np.testing.assert_allclose(host(logits[:, 0]), host(full[:, t]),
                                   **STEP_TOL, err_msg=f"{name} pos {t}")


# ---------------------------------------------------------------------------
# the prod training step on reduced(qwen3-moe-30b-a3b)
# ---------------------------------------------------------------------------

QWEN3 = "qwen3-moe-30b-a3b"
STEP_KW = dict(fb_ratio=2, update_delay=1, use_pallas=True)


def _lm_batches(vocab, M, steps, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, vocab, (M, 4, 17)).astype(np.int32)
        out.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    return out


def test_m1_prod_step_matches_jax(monkeypatch):
    """The prod step at M=1, R=2, D=1 on reduced(qwen3-moe-30b-a3b), per
    step: loss, staleness, Σw, disagreement and the read plane."""
    monkeypatch.setattr(jnp, "repeat", repeat_without_sharding)
    jm, jp, tm, _ = model_pair(QWEN3)
    jbe = jax_make_backend(
        "prod", "layup", M=1, loss_fn=lambda p, b: jm.loss_fn(p, b,
                                                              block_k=8),
        optimizer=jax_momentum(0.9), schedule=jax_constant(0.05), **STEP_KW)
    tbe = make_backend("prod", "layup", M=1, loss_fn=tm.loss_fn,
                       optimizer=momentum(0.9), schedule=constant(0.05),
                       device="cpu", **STEP_KW)
    js = jbe.init(jax.random.PRNGKey(0), jp)
    ts = tbe.init(None, np_tree(jp))
    for t, b in enumerate(_lm_batches(jm.cfg.vocab_size, 1, 3)):
        js, jmet = jbe.step(js, jax.tree.map(jnp.asarray, b),
                            jax.random.PRNGKey(t))
        ts, tmet = tbe.step(ts, b, None)
        compare_metrics(tmet, jmet, t)
        compare_planes(ts["read"], js["read"], rtol=1e-4)


def _run(M, **engine):
    """Host copies of each step's metrics and the final read plane of the
    port's prod step on reduced(qwen3-moe-30b-a3b)."""
    model = build_model(reduced(get_config(QWEN3)))
    be = make_backend("prod", "layup", M=M, loss_fn=model.loss_fn,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      device="cpu", wait_timeout_s=20.0, **STEP_KW, **engine)
    try:
        st = be.init(None, model.init(seed=0, device="cpu"))
        hist = []
        for b in _lm_batches(model.cfg.vocab_size, M, 3):
            st, m = be.step(st, b)
            hist.append({k: np.asarray(m[k]) for k in (
                "loss", "update_staleness", "layer_staleness", "weight_sum",
                "disagreement", "staleness_mean")})
        read = {k: v.clone() for k, v in materialize(be, st["read"]).items()}
    finally:
        if hasattr(be.engine, "close"):
            be.engine.close()
    return hist, {"read": read}


def test_pipeline_engine_bit_exact_vs_monolithic():
    """M=2: the stage-graph engine (``overlap=True``) gives the monolithic
    step's metrics and read plane bit for bit on the MoE model."""
    want = _run(2)
    assert_runs_equal(_run(2, overlap=True), want)
    assert all(np.isfinite(h["loss"]) for h in want[0])
