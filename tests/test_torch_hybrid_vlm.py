"""The port's hybrid family (jamba-v0.1-52b: SSM and attention sub-layers
in one super-block, MoE on every second layer) and its VLM backbone
(qwen2-vl-2b: embeddings in, M-RoPE over (3, B, S) positions) against the
JAX package's, at the reduced sizes of ``configs.base.reduced``: spec
trees (also jamba's real period-8 super-block at reduced widths), the loss
with ``ce``, ``aux`` and grads, ``prefill_fn`` and ``decode_fn``, the
incremental decode against the full forward inside the port,
``apply_mrope`` and ``synth_mrope_positions`` with an image span, the
forward-slice split of a VLM batch, the prod step at M=1 (the VLM's M=2
step runs in ``test_torch_train_multiworker.py``), and inside the port a
VLM batch through both engines and a chaos plan, bit-exact with the
monolithic step.

Parameters come from one JAX init carried across with
``repro_torch.convert``; inputs are drawn with numpy. Tolerances (float32
on the CPU; XLA and PyTorch sum products in different orders): loss, ce
and aux rtol 1e-5; grads rtol 1e-4 with an atol of 1e-4 of each leaf's
largest gradient; logits and caches rtol 1e-4 / atol 1e-5; the prod
step's metrics rtol 1e-5 and plane rtol 1e-4 (``_torch_parity.py``'s).

The port's attention masks by index, as the reference's kernel route
(``USE_PALLAS``) does; the reference's plain route masks by the temporal
ids, which stand still inside an image span. The image-span loss is held
to the plain route with its positions replaced by indices.
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
from repro.launch.train import _split_fwd_slices as jax_split  # noqa: E402
from repro.models import frontends as JF  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.transformer import decoder_specs as jax_specs  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro.optim import momentum as jax_momentum  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.backend import make_backend  # noqa: E402
from repro_torch.core.pytree import (tree_flatten_with_path,  # noqa: E402
                                     tree_leaves)
from repro_torch.launch.train import _split_fwd_slices  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import frontends as TF  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import constant, momentum  # noqa: E402

JAMBA, VLM = "jamba-v0.1-52b", "qwen2-vl-2b"
FAMILIES = [JAMBA, VLM]
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
# an image span: tokens [5, 9) form a 2 x 2 grid
SPAN = (5, 9, 2)


def host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _positions(B, S, span=None):
    return np.asarray(JF.synth_mrope_positions(B, S, image_span=span))


def _batch(cfg, B, S, seed, span=None):
    """numpy inputs of ``cfg``'s family: tokens, or (VLM) embeddings of
    N(0, 0.02²) with M-RoPE positions; labels."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.frontend == "vision":
        out["embeds"] = (rng.standard_normal((B, S, cfg.d_model))
                         * 0.02).astype(np.float32)
        out["positions"] = _positions(B, S, span)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    return out


def _spec_tree_equal(tspecs, jspecs):
    tflat, _ = tree_flatten_with_path(tspecs)
    jflat, _ = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda s: isinstance(s, JL.ParamSpec))
    assert [[e.key for e in p] for p, _ in tflat] == \
        [[e.key for e in p] for p, _ in jflat]
    for (_, ts), (_, js) in zip(tflat, jflat):
        assert (ts.shape, ts.axes, ts.init) == (js.shape, js.axes, js.init)
        np.testing.assert_allclose(ts.scale, js.scale, rtol=1e-12)


@pytest.mark.parametrize("name,kw", [
    (JAMBA, {}), (VLM, {}),
    (JAMBA, dict(num_layers=8, attn_layer_period=8))],
    ids=["jamba", "qwen2-vl", "jamba-period8"])
def test_decoder_specs_match_reference_tree(name, kw):
    """Paths, shapes, axes, init kinds and scales of the reduced and the
    full config (nothing is allocated); the reduced configs equal the JAX
    package's ``reduced`` field for field. ``jamba-period8``: jamba's real
    super-block (attention at sub4, MoE at the odd subs) at reduced
    widths."""
    jr = jax_reduced(jax_get_config(name)).with_(**kw)
    tr = reduced(get_config(name)).with_(**kw)
    assert tr == torch_cfg(jr)
    for tcfg, jcfg in ((tr, jr), (get_config(name), jax_get_config(name))):
        _spec_tree_equal(T.decoder_specs(tcfg), jax_specs(jcfg))
    blocks = T.decoder_specs(tr)["blocks"]
    if name == JAMBA:
        period = tr.attn_layer_period
        assert len(blocks) == period
        for i in range(period):
            assert set(blocks[f"sub{i}"]) == {
                "attn" if i == period // 2 else "ssm", "mlp"}
            assert ("router" in blocks[f"sub{i}"]["mlp"]) == (i % 2 == 1)
    else:
        assert set(blocks) == {"sub0"} and tr.mrope


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_ce_aux_and_grads_match_jax(name):
    jm, jp, tm, tp = model_pair(name)
    batch = _batch(jm.cfg, 2, 16, seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jb, block_k=8), has_aux=True))(jp)

    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tloss, tmet = tm.loss_fn(tp, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    # jamba: one MoE layer (sub1), its aux near 1; the VLM has none
    assert (tmet["aux"].item() > 0.5) == (name == JAMBA)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(tgrads)
    for tg, jg in zip(tgrads, jleaves):
        jg = np.asarray(jg)
        np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-4,
                                   atol=1e-4 * np.abs(jg).max())


def test_vlm_image_span_loss_matches_jax_kernel_route(monkeypatch):
    """An image span (t held at its first token, h and w over a 2 x 2
    grid): M-RoPE rotates by the three axes, and the mask is by index, as
    on the reference's kernel route. The JAX loss runs its plain attention
    with positions replaced by indices, which is that route's function."""
    plain = JL.flash_attention_jnp

    def by_index(q, k, v, *, q_positions, k_positions, **kw):
        iq = jnp.broadcast_to(jnp.arange(q.shape[1])[None], q_positions.shape)
        ik = jnp.broadcast_to(jnp.arange(k.shape[1])[None], k_positions.shape)
        return plain(q, k, v, q_positions=iq, k_positions=ik, **kw)

    monkeypatch.setattr(JL, "flash_attention_jnp", by_index)
    jm, jp, tm, tp = model_pair(VLM)
    batch = _batch(jm.cfg, 2, 16, seed=4, span=SPAN)
    assert not np.array_equal(batch["positions"][0], batch["positions"][1])
    jloss, _ = jax.jit(lambda p: jm.loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, block_k=8))(jp)
    tloss, _ = tm.loss_fn(tp, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    arange = dict(batch, positions=_positions(2, 16))
    tloss0, _ = tm.loss_fn(tp, {k: torch.from_numpy(v)
                                for k, v in arange.items()})
    assert abs(tloss0.item() - tloss.item()) > 1e-6  # the span is seen


def test_apply_mrope_and_positions_match_jax():
    """``synth_mrope_positions`` with and without an image span, and
    ``apply_mrope`` by them (head dims 32 and 128, θ 1e6), against the
    JAX package's."""
    for span in (None, SPAN, (3, 12, 3)):
        want = _positions(2, 16, span)
        got = TF.synth_mrope_positions(2, 16, image_span=span, device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    rng = np.random.default_rng(0)
    for D in (32, 128):
        x = rng.standard_normal((2, 16, 3, D)).astype(np.float32)
        pos = _positions(2, 16, (3, 12, 3))
        want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta=1e6)
        got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta=1e6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
        assert TL.mrope_sections(D) == [D // 8, 3 * D // 16,
                                         D // 2 - D // 8 - 3 * D // 16]


@pytest.mark.parametrize("R", [2, 3])
def test_split_fwd_slices_of_vlm_batch_match_reference(R):
    """Each leaf splits on its batch dim: the (3, B, S) positions on dim
    1, embeddings and labels on dim 0; the slices equal the reference's."""
    cfg = reduced(get_config(VLM))
    batch = _batch(cfg, 6, 8, seed=5, span=(1, 5, 2))
    batch["positions"] = batch["positions"] + np.arange(6, dtype=np.int32)[
        None, :, None]
    want = jax_split({k: jnp.asarray(v) for k, v in batch.items()}, R)
    got = _split_fwd_slices({k: torch.from_numpy(v)
                             for k, v in batch.items()}, R)
    assert len(got) == len(want) == R
    for g, w in zip(got, want):
        assert g["positions"].shape == (3, 6 // R, 8)
        for k in batch:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_fn_and_prefill_fn_match_jax(name):
    """``decode_fn`` step by step (each sequence at its own position) and
    ``prefill_fn`` (the VLM's on the embeddings of the same tokens with
    ``arange`` positions), logits and caches, against the JAX
    package's."""
    jm, jp, tm, tp = model_pair(name)
    B, S = 2, 12
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
    if name == VLM:
        emb = np.asarray(jp["embed"]["tok"])[toks]
        batch = {"embeds": emb, "positions": _positions(B, S)}
    else:
        batch = {"tokens": toks}
    jc, jlog = jm.prefill_fn(jp, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, block_k=4)
    tc, tlog = tm.prefill_fn(tp, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    np.testing.assert_allclose(host(tlog), host(jlog), **STEP_TOL)
    assert_tree_close(tc, jc, f"{name} prefill cache", **STEP_TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_incremental_decode_matches_full_forward(name):
    """As ``tests/test_decode_consistency.py``: the one-token steps
    reproduce the full forward's logits at every position (jamba at
    ``capacity_factor=8``, where nothing drops; the VLM's forward on the
    tokens' embeddings with ``arange`` on the three axes)."""
    kw = dict(capacity_factor=8.0) if name == JAMBA else {}
    _, _, tm, tp = model_pair(name, seed=7, **kw)
    cfg = tm.cfg
    B, S = 2, 16
    toks = torch.from_numpy(_tokens(cfg.vocab_size, B, S, 8))
    with torch.no_grad():
        h = TL.embed_apply(tp["embed"], toks)
        pos = torch.arange(S)[None].expand(B, S)
        mrope = pos[None].expand(3, B, S) if cfg.mrope else None
        h, _, _ = T.decoder_forward(tp, h, cfg, positions=pos,
                                    mrope_pos=mrope)
        full = TL.unembed_apply(
            tp["embed"], TL.rmsnorm(h, tp["final_norm"], cfg.norm_eps),
            cfg.tie_embeddings)
    cache = T.alloc_cache(tm.cache_specs(B, S), device="cpu")
    for t in range(S):
        logits, cache = tm.decode_fn(tp, cache, toks[:, t:t + 1],
                                     torch.full((B,), t))
        np.testing.assert_allclose(host(logits[:, 0]), host(full[:, t]),
                                   **STEP_TOL, err_msg=f"{name} pos {t}")


STEP_KW = dict(fb_ratio=2, update_delay=1, use_pallas=True)


def _step_batches(cfg, M, steps, seed=5):
    """Per-step batches with a leading worker axis (positions (M, 3, B,
    S), each sequence's ids offset so that a wrong split shows)."""
    out = []
    for t in range(steps):
        b = _batch(cfg, M * 4, 16, seed=seed + t)
        if "positions" in b:
            b["positions"] = b["positions"] + np.arange(
                M * 4, dtype=np.int32)[None, :, None]
            b["positions"] = b["positions"].reshape(3, M, 4, 16).transpose(
                1, 0, 2, 3).copy()
        out.append({k: (v if k == "positions" else v.reshape(
            (M, 4) + v.shape[1:])) for k, v in b.items()})
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_m1_prod_step_matches_jax(monkeypatch, name):
    """The prod step at M=1, R=2, D=1, per step: loss, staleness, Σw,
    disagreement and the read plane (the VLM's positions split on their
    batch dim)."""
    monkeypatch.setattr(jnp, "repeat", repeat_without_sharding)
    jm, jp, tm, _ = model_pair(name)
    jbe = jax_make_backend(
        "prod", "layup", M=1, loss_fn=lambda p, b: jm.loss_fn(p, b,
                                                              block_k=8),
        optimizer=jax_momentum(0.9), schedule=jax_constant(0.05), **STEP_KW)
    tbe = make_backend("prod", "layup", M=1, loss_fn=tm.loss_fn,
                       optimizer=momentum(0.9), schedule=constant(0.05),
                       device="cpu", **STEP_KW)
    js = jbe.init(jax.random.PRNGKey(0), jp)
    ts = tbe.init(None, np_tree(jp))
    for t, b in enumerate(_step_batches(jm.cfg, 1, 2)):
        js, jmet = jbe.step(js, jax.tree.map(jnp.asarray, b),
                            jax.random.PRNGKey(t))
        ts, tmet = tbe.step(ts, b, None)
        compare_metrics(tmet, jmet, t)
        compare_planes(ts["read"], js["read"], rtol=1e-4)


def _vlm_run(**engine):
    """Host copies of each step's metrics and the final read plane of the
    port's prod step on reduced(qwen2-vl-2b) at M=2, R=2, D=0, with a NaN
    injected into worker 0's batch at step 1 (the chaos controller poisons
    the floating leaves, here the embeddings, and leaves the integer
    positions as they are)."""
    model = build_model(reduced(get_config(VLM)))
    be = make_backend("prod", "layup", M=2, loss_fn=model.loss_fn,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      fb_ratio=2, update_delay=0, use_pallas=True,
                      device="cpu", wait_timeout_s=20.0,
                      faults="nan:step=1,peer=0,group=0", **engine)
    try:
        st = be.init(None, model.init(seed=0, device="cpu"))
        hist = []
        for b in _step_batches(model.cfg, 2, 3):
            st, m = be.step(st, b)
            hist.append({k: np.asarray(m[k]) for k in (
                "loss", "update_staleness", "layer_staleness", "weight_sum",
                "disagreement", "staleness_mean", "nonfinite_skips")})
        read = {k: v.clone() for k, v in materialize(be, st["read"]).items()}
    finally:
        if hasattr(be.engine, "close"):
            be.engine.close()
    return hist, {"read": read}


def test_vlm_batch_through_engines_and_chaos():
    """The (3, B, S) positions leaf passes the stage-graph engine
    (``overlap=True``), the stream engine (``streams=3``) and the chaos
    controller's batch poisoning unharmed: both engines give the
    monolithic step's metrics and read plane bit for bit, and the poisoned
    step's update is skipped as nonfinite (worker 0's three groups)."""
    want = _vlm_run()
    assert [float(h["nonfinite_skips"]) for h in want[0]] == [0.0, 3.0, 0.0]
    assert all(np.isfinite(h["weight_sum"]) for h in want[0])
    for engine in (dict(overlap=True), dict(overlap=True, streams=3)):
        assert_runs_equal(_vlm_run(**engine), want)
