"""The port's decode path (``layers.decode_attention``,
``ssm.ssm_block_decode``, the transformer's decode sub-layers and cache
specs, ``Model.prefill_fn`` / ``decode_fn`` / ``cache_specs``) against the
JAX package's on the same numpy inputs, and against the port's own full
forward (as ``tests/test_decode_consistency.py`` pins it inside JAX).

Parameters come from one JAX init carried across with
``repro_torch.convert``. Tolerances (XLA and PyTorch order the sums of
products differently):
* ``decode_attention``: float32 rtol 1e-5 / atol 1e-6;
* ``ssm_block_decode``: float32 rtol 1e-5 / atol 1e-6; bfloat16 2e-2 of the
  largest |value| (both sides round the same casts to 8 bits, in different
  sum orders);
* ``decode_fn`` step by step and ``prefill_fn`` against JAX (float32):
  logits and caches rtol 1e-4 / atol 1e-5;
* the incremental decode against the port's own full forward: rtol 1e-4 /
  atol 1e-5 (the reference's own test allows 5e-3).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from _torch_parity import _TORCH_DTYPES, torch_cfg  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core.pytree import tree_leaves  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_REL = 2e-2


def host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def jax_cfg(name):
    if name == "dense-swa":
        # test_decode_consistency's ring-buffer config, without the MoE the
        # port does not build
        return reduced(jax_get_config("granite-8b")).with_(
            sliding_window=8, d_ff=128)
    return reduced(jax_get_config(name))


def models(name, seed=0):
    """(jax model, jax params, port model, port params) of one init."""
    jcfg = jax_cfg(name)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(torch_cfg(jcfg))
    tp = to_torch(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------

# (B, Sc, Hq, Hkv, D, window, ring, empty)
ATTN_CASES = [
    (2, 16, 4, 4, 32, 0, False, False),   # MHA
    (2, 16, 8, 2, 32, 0, False, False),   # GQA
    (3, 12, 4, 1, 16, 0, False, True),    # MQA, empty slots
    (2, 8, 4, 2, 32, 8, True, False),     # window over a ring buffer
    (2, 8, 4, 2, 32, 6, True, True),      # window < ring, empty slots
    (1, 24, 4, 2, 64, 0, False, True),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_decode_attention_matches_jax(case):
    B, Sc, Hq, Hkv, D, window, ring, empty = case
    rng = np.random.default_rng(sum(case[:5]))
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Sc, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sc, Hkv, D)).astype(np.float32)
    qpos = rng.integers(Sc // 2, 3 * Sc, B).astype(np.int32)
    idx = np.arange(Sc)[None]
    if ring:
        kpos = qpos[:, None] - (qpos[:, None] - idx) % Sc
    else:
        kpos = np.broadcast_to(idx, (B, Sc)).copy()
        qpos = np.minimum(qpos, Sc - 1)
    if empty:
        kpos[:, -3:] = -1
    kpos = kpos.astype(np.int32)
    want = JL.decode_attention_jnp(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_position=jnp.asarray(qpos), k_positions=jnp.asarray(kpos),
        window=window)
    got = TL.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_position=torch.from_numpy(qpos).long(),
        k_positions=torch.from_numpy(kpos).long(), window=window)
    assert got.shape == (B, 1, Hq, D) and got.dtype == torch.float32
    np.testing.assert_allclose(host(got), host(want), **F32_TOL)


def test_decode_attention_keeps_q_dtype_and_sums_in_f32():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(torch.bfloat16)
               for s in ((2, 1, 4, 32), (2, 8, 2, 32), (2, 8, 2, 32)))
    pos = torch.tensor([7, 5])
    kpos = torch.arange(8)[None].expand(2, 8)
    got = TL.decode_attention(q, k, v, q_position=pos, k_positions=kpos)
    assert got.dtype == torch.bfloat16
    want = JL.decode_attention_jnp(
        *(jnp.asarray(host(t), jnp.bfloat16) for t in (q, k, v)),
        q_position=jnp.asarray(pos.numpy()),
        k_positions=jnp.asarray(kpos.numpy()))
    np.testing.assert_allclose(host(got), host(want), rtol=0,
                               atol=BF16_REL * np.abs(host(want)).max())


# ---------------------------------------------------------------------------
# ssm_block_decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_decode_matches_jax(dtype):
    jcfg = reduced(jax_get_config("mamba2-780m")).with_(
        dtype=jnp.dtype(dtype).type)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    sub_j = jax.tree.map(lambda x: x[0], jp["blocks"]["sub0"]["ssm"])
    sub_t = to_torch(jax.tree.map(np.asarray, sub_j), "cpu")
    cfg = torch_cfg(jcfg)
    rng = np.random.default_rng(2)
    B, conv_dim = 3, cfg.d_inner + 2 * cfg.ssm_state
    x = (rng.standard_normal((B, 1, cfg.d_model)) * 0.5).astype(np.float32)
    st = (rng.standard_normal((B, cfg.ssm_heads, cfg.ssm_state,
                               cfg.ssm_head_dim)) * 0.1).astype(np.float32)
    tail = (rng.standard_normal((B, cfg.ssm_conv - 1, conv_dim)) * 0.5
            ).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want_y, (want_st, want_tail) = JS.ssm_block_decode(
        sub_j, jnp.asarray(x, jdt), jcfg, jnp.asarray(st, jdt),
        jnp.asarray(tail, jdt))
    tdt = _TORCH_DTYPES[dtype]
    got_y, (got_st, got_tail) = TS.ssm_block_decode(
        sub_t, torch.from_numpy(x).to(tdt), cfg, torch.from_numpy(st).to(tdt),
        torch.from_numpy(tail).to(tdt))
    # the recurrence promotes the state to float32, as the reference's does
    assert got_st.dtype == torch.float32 and want_st.dtype == jnp.float32
    assert got_y.dtype == tdt and got_tail.dtype == tdt
    for g, w in ((got_y, want_y), (got_st, want_st), (got_tail, want_tail)):
        assert tuple(g.shape) == tuple(w.shape)
        if dtype == "float32":
            np.testing.assert_allclose(host(g), host(w), **F32_TOL)
        else:
            np.testing.assert_allclose(
                host(g), host(w), rtol=0,
                atol=BF16_REL * np.abs(host(w)).max())


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,B,seq_len,dtype", [
    ("granite-8b", 2, 32, None), ("stablelm-1.6b", 1, 7, None),
    ("mamba2-780m", 4, 16, None), ("dense-swa", 2, 24, None),
    ("dense-swa", 2, 5, None), ("granite-8b", 2, 8, "bfloat16"),
    ("gpt2-medium-full", 8, 512, None), ("mamba2-780m-full", 8, 256, None)])
def test_cache_specs_match_jax(name, B, seq_len, dtype):
    if name.endswith("-full"):
        jcfg = jax_get_config(name[:-len("-full")])
    else:
        jcfg = jax_cfg(name)
    want = jax_build_model(jcfg).cache_specs(
        B, seq_len, None if dtype is None else jnp.dtype(dtype))
    got = build_model(torch_cfg(jcfg)).cache_specs(
        B, seq_len, None if dtype is None else _TORCH_DTYPES[dtype])
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda s: 0, got,
                     is_leaf=lambda s: isinstance(s, T.CacheSpec)))
    for path, w in jax.tree.flatten_with_path(want)[0]:
        g = got
        for e in path:
            g = g[e.key]
        assert g.shape == tuple(w.shape), path
        assert g.dtype == _TORCH_DTYPES[jnp.dtype(w.dtype).name], path


def test_alloc_cache_needs_a_device():
    specs = build_model(torch_cfg(jax_cfg("granite-8b"))).cache_specs(2, 8)
    with pytest.raises(TypeError):
        T.alloc_cache(specs)
    cache = T.alloc_cache(specs, device="cpu")
    assert all(not bool(c.any()) for c in tree_leaves(cache))


# ---------------------------------------------------------------------------
# decode_fn and prefill_fn against JAX
# ---------------------------------------------------------------------------

FAMILIES = ["granite-8b", "stablelm-1.6b", "mamba2-780m", "dense-swa"]


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_fn_matches_jax_step_by_step(name):
    jm, jp, tm, tp = models(name)
    B, S = 2, 24 if name == "dense-swa" else 12
    toks = _tokens(jm.cfg, B, S, 4)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jm.cache_specs(B, S))
    tcache = T.alloc_cache(tm.cache_specs(B, S), device="cpu")
    jstep = jax.jit(jm.decode_fn)
    for t in range(S):
        # staggered positions: each sequence at its own position
        pos = np.asarray([t, max(t - 1, 0)], np.int32)
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.asarray(pos))
        tl, tcache = tm.decode_fn(tp, tcache, torch.from_numpy(toks[:, t:t + 1]),
                                  torch.from_numpy(pos).long())
        assert tl.dtype == torch.float32 and tl.shape == (B, 1, jm.cfg.vocab_size)
        np.testing.assert_allclose(host(tl), host(jl), **STEP_TOL,
                                   err_msg=f"{name} logits at step {t}")
    for path, w in jax.tree.flatten_with_path(jcache)[0]:
        g = tcache
        for e in path:
            g = g[e.key]
        np.testing.assert_allclose(host(g), host(w), **STEP_TOL,
                                   err_msg=f"{name} cache {path}")


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_fn_matches_jax(name):
    jm, jp, tm, tp = models(name)
    B, S = 2, 24 if name == "dense-swa" else 16
    toks = _tokens(jm.cfg, B, S, 5)
    jcache, jlogits = jm.prefill_fn(jp, {"tokens": jnp.asarray(toks)},
                                    block_k=8)
    tcache, tlogits = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
    assert tuple(tlogits.shape) == tuple(jlogits.shape) == (B, 1,
                                                            jm.cfg.vocab_size)
    np.testing.assert_allclose(host(tlogits), host(jlogits), **STEP_TOL)
    assert jax.tree.structure(jcache) == jax.tree.structure(
        jax.tree.map(lambda x: 0, tcache))
    for path, w in jax.tree.flatten_with_path(jcache)[0]:
        g = tcache
        for e in path:
            g = g[e.key]
        assert tuple(g.shape) == tuple(w.shape), path
        np.testing.assert_allclose(host(g), host(w), **STEP_TOL,
                                   err_msg=f"{name} cache {path}")


def test_prefill_and_decode_run_in_inference_mode():
    _, _, tm, tp = models("granite-8b")
    toks = torch.from_numpy(_tokens(tm.cfg, 1, 4, 6))
    cache, logits = tm.prefill_fn(tp, {"tokens": toks})
    assert logits.is_inference() and not logits.requires_grad
    assert all(c.is_inference() for c in tree_leaves(cache))
    tcache = T.alloc_cache(tm.cache_specs(1, 8), device="cpu")
    logits, out = tm.decode_fn(tp, tcache, toks[:, :1], torch.zeros(1).long())
    # the cache is written in place and handed back, still a normal tensor
    assert out is tcache and not tcache["sub0"]["k"].is_inference()
    assert bool(tcache["sub0"]["k"][:, :, 0].any())
    assert not bool(tcache["sub0"]["k"][:, :, 1:].any())


# ---------------------------------------------------------------------------
# the incremental decode against the port's own full forward
# ---------------------------------------------------------------------------


def _full_logits(tm, tp, toks):
    cfg = tm.cfg
    B, S = toks.shape
    with torch.no_grad():
        h = TL.embed_apply(tp["embed"], toks)
        pos = torch.arange(S)[None].expand(B, S)
        h, _, _ = T.decoder_forward(tp, h, cfg, positions=pos)
        h = TL.rmsnorm(h, tp["final_norm"], cfg.norm_eps)
        return TL.unembed_apply(tp["embed"], h, cfg.tie_embeddings)


@pytest.mark.parametrize("name", FAMILIES)
def test_incremental_decode_matches_full_forward(name):
    _, _, tm, tp = models(name, seed=7)
    B, S = 2, 24 if name == "dense-swa" else 16
    toks = torch.from_numpy(_tokens(tm.cfg, B, S, 8))
    full = _full_logits(tm, tp, toks)
    cache = T.alloc_cache(tm.cache_specs(B, S), device="cpu")
    if name == "dense-swa":
        assert cache["sub0"]["k"].shape[2] == 8  # ring capacity = window
    for t in range(S):
        logits, cache = tm.decode_fn(tp, cache, toks[:, t:t + 1],
                                     torch.full((B,), t))
        np.testing.assert_allclose(host(logits[:, 0]), host(full[:, t]),
                                   **STEP_TOL, err_msg=f"{name} pos {t}")


# ---------------------------------------------------------------------------
# Mamba2 in bf16: the chunked form (prefill) against the recurrence (decode)
# ---------------------------------------------------------------------------


def _bf16_mamba(layers=4):
    jcfg = reduced(jax_get_config("mamba2-780m")).with_(
        num_layers=layers, dtype=jnp.bfloat16)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(9))
    tm = build_model(torch_cfg(jcfg))
    return jm, jp, tm, to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _gap(a, b):
    a, b = host(a), host(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_ssm_bf16_layer_local_prefill_matches_decode():
    """Each layer's chunked form and its recurrence on the same inputs
    (prefill's hidden states entering the layer) agree to 2e-2 of the
    largest |value| in bf16, state and conv tail, as chip_smoke.py's
    serve_ssm holds them at full size."""
    _, _, tm, tp = _bf16_mamba()
    cfg = tm.cfg
    toks = torch.from_numpy(_tokens(cfg, 1, 40, 10))
    with torch.inference_mode():
        h = TL.embed_apply(tp["embed"], toks)
        for _, sub in T.decoder_layers(tp):
            h_in = h
            h, (state, tail) = T.ssm_sublayer(sub["ssm"], h, cfg,
                                              return_state=True)
            c = {"state": torch.zeros_like(state),
                 "conv_tail": torch.zeros_like(tail)}
            for t in range(toks.shape[1]):
                T.ssm_sublayer_decode(sub["ssm"], h_in[:, t:t + 1], cfg, c)
            assert _gap(c["state"], state) <= BF16_REL
            assert _gap(c["conv_tail"], tail) <= BF16_REL


def test_ssm_bf16_prefill_decode_drift_as_the_reference():
    """End to end in bf16 the two forms' roundings compound over the
    layers; the port's gaps (last logits, each layer's final state) stay
    within twice the reference's own gaps plus 1e-2, on the same weights
    and prompt."""
    jm, jp, tm, tp = _bf16_mamba()
    S = 40
    toks = _tokens(tm.cfg, 1, S, 11)
    jc, jl = jm.prefill_fn(jp, {"tokens": jnp.asarray(toks)})
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jm.cache_specs(1, S))
    jstep = jax.jit(jm.decode_fn)
    tc, tl = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
    tcache = T.alloc_cache(tm.cache_specs(1, S), device="cpu")
    for t in range(S):
        jd, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.asarray([t], jnp.int32))
        td, tcache = tm.decode_fn(tp, tcache,
                                  torch.from_numpy(toks[:, t:t + 1]),
                                  torch.tensor([t]))
    ref = [_gap(jd, jl)] + [
        _gap(a, b) for a, b in zip(jcache["sub0"]["state"],
                                   jc["sub0"]["state"])]
    got = [_gap(td, tl)] + [
        _gap(a, b) for a, b in zip(tcache["sub0"]["state"],
                                   tc["sub0"]["state"])]
    for g, r in zip(got, ref):
        assert g <= 2 * r + 1e-2, (got, ref)
