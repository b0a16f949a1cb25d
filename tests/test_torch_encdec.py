"""The port's encoder-decoder (whisper-large-v3) against the JAX package's,
at the reduced size of ``configs.base.reduced`` (2 + 2 layers, 16 encoder
frames): the spec tree, the loss and its grads (encoder self-attention,
decoder self- and cross-attention through ``layers.attention``),
``prefill_fn`` (encoder, cross K/V, first token) and ``decode_fn`` step by
step, the incremental decode against ``decode_train``'s teacher-forced
logits inside the port (``tests/test_decode_consistency.py``'s whisper
case), the sinusoidal positions, and the prod step at M=1.

Parameters come from one JAX init carried across with
``repro_torch.convert``; inputs are drawn with numpy. Tolerances (float32
on the CPU; XLA and PyTorch sum products in different orders): loss rtol
1e-5; grads rtol 1e-4 with an atol of 1e-4 of each leaf's largest
gradient; logits and caches rtol 1e-4 / atol 1e-5; the prod step's
metrics rtol 1e-5 and plane rtol 1e-4 (``_torch_parity.py``'s).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import (assert_tree_close, compare_metrics,  # noqa: E402
                           compare_planes, model_pair, np_tree, torch_cfg)
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.backend import make_backend as jax_make_backend  # noqa: E402
from repro.models import encdec as JED  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro.optim import momentum as jax_momentum  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.backend import make_backend  # noqa: E402
from repro_torch.core.pytree import (tree_flatten_with_path,  # noqa: E402
                                     tree_leaves)
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.optim import constant, momentum  # noqa: E402

WHISPER = "whisper-large-v3"
STEP_TOL = dict(rtol=1e-4, atol=1e-5)


def host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _batch(cfg, B, S, seed):
    """numpy audio frames (N(0, 0.1²)), tokens and labels."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"audio_embeds": (rng.standard_normal((B, cfg.enc_seq,
                                                  cfg.d_model))
                             * 0.1).astype(np.float32),
            "tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_encdec_specs_match_reference_tree():
    """Paths, shapes, axes, init kinds and scales of the reduced and the
    full config (nothing is allocated); the reduced config equals the JAX
    package's ``reduced`` field for field."""
    jr = jax_reduced(jax_get_config(WHISPER))
    tr = reduced(get_config(WHISPER))
    assert tr == torch_cfg(jr)
    for tcfg, jcfg in ((tr, jr), (get_config(WHISPER),
                                  jax_get_config(WHISPER))):
        tflat, _ = tree_flatten_with_path(ED.encdec_specs(tcfg))
        jflat, _ = jax.tree_util.tree_flatten_with_path(
            JED.encdec_specs(jcfg),
            is_leaf=lambda s: isinstance(s, JL.ParamSpec))
        assert [[e.key for e in p] for p, _ in tflat] == \
            [[e.key for e in p] for p, _ in jflat]
        for (_, ts), (_, js) in zip(tflat, jflat):
            assert (ts.shape, ts.axes, ts.init) == (js.shape, js.axes,
                                                    js.init)
            np.testing.assert_allclose(ts.scale, js.scale, rtol=1e-12)
    specs = ED.encdec_specs(get_config(WHISPER))
    assert specs["enc_blocks"]["attn"]["wq"].shape == (32, 1280, 20, 64)
    assert specs["dec_blocks"]["cross"]["wk"].shape == (32, 1280, 20, 64)


def test_loss_and_grads_match_jax():
    jm, jp, tm, tp = model_pair(WHISPER)
    batch = _batch(jm.cfg, 2, 8, seed=3)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, _j(batch), block_k=8), has_aux=True))(jp)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tloss, tmet = tm.loss_fn(tp, _t(batch))
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tmet["ce"].item(), float(jmet["ce"]),
                               rtol=1e-5)
    assert tmet["aux"].item() == 0.0 and tmet["aux"].dtype == torch.float32
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(tgrads)
    for tg, jg in zip(tgrads, jleaves):
        jg = np.asarray(jg)
        np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-4,
                                   atol=1e-4 * np.abs(jg).max())


def test_prefill_fn_and_decode_fn_match_jax():
    """``prefill_fn`` (encoder, cross K/V, a zeroed self cache, the first
    token) and then ``decode_fn`` over the later tokens, logits at every
    step and the final caches, against the JAX package's."""
    jm, jp, tm, tp = model_pair(WHISPER)
    B, S = 2, 8
    batch = _batch(jm.cfg, B, S, seed=4)
    jc, jl = jm.prefill_fn(jp, _j(batch), block_k=8)
    tc, tl = tm.prefill_fn(tp, _t(batch))
    np.testing.assert_allclose(host(tl), host(jl), **STEP_TOL)
    assert_tree_close(tc, jc, "prefill cache", **STEP_TOL)
    jstep = jax.jit(jm.decode_fn)
    toks = batch["tokens"]
    for t in range(1, S):
        pos = np.full((B,), t, np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                       jnp.asarray(pos))
        tl, tc = tm.decode_fn(tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                              torch.from_numpy(pos).long())
        np.testing.assert_allclose(host(tl), host(jl), **STEP_TOL,
                                   err_msg=f"logits at step {t}")
    assert_tree_close(tc, jc, "cache", **STEP_TOL)


def test_incremental_decode_matches_decode_train():
    """As ``test_whisper_decode_consistency``: ``prefill_fn`` and then
    one-token ``decode_fn`` steps reproduce ``decode_train``'s
    teacher-forced logits at every position; the cross cache is never
    written."""
    _, _, tm, tp = model_pair(WHISPER, seed=7)
    cfg = tm.cfg
    B, S = 2, 8
    batch = _t(_batch(cfg, B, S, seed=8))
    with torch.no_grad():
        enc_h = ED.encode(tp, batch["audio_embeds"], cfg)
        full = ED.decode_train(tp, enc_h, batch["tokens"], cfg)
    cache, logits = tm.prefill_fn(tp, batch)
    cross = {k: v.clone() for k, v in cache["cross"].items()}
    np.testing.assert_allclose(host(logits[:, 0]), host(full[:, 0]),
                               **STEP_TOL)
    for t in range(1, S):
        logits, cache = tm.decode_fn(tp, cache, batch["tokens"][:, t:t + 1],
                                     torch.full((B,), t))
        np.testing.assert_allclose(host(logits[:, 0]), host(full[:, t]),
                                   **STEP_TOL, err_msg=f"pos {t}")
    for k in cross:
        assert torch.equal(cache["cross"][k], cross[k])


def test_sinusoids_match_jax():
    """``sinusoidal_positions`` (numpy, as the reference's: identical) and
    ``_sinusoid_at`` (its rows, from positions on the device) against the
    JAX package's."""
    for S, d in ((16, 256), (1500, 1280)):
        got = TL.sinusoidal_positions(S, d, device="cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            JL.sinusoidal_positions(S, d)))
    pos = np.asarray([0, 1, 7, 255, 1499], np.int32)
    want = np.asarray(JED._sinusoid_at(jnp.asarray(pos), 1280))
    got = ED._sinusoid_at(torch.from_numpy(pos), 1280)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the table divides by 10000^(2i/d), the row multiplies by its
    # reciprocal: the angles differ by a rounding, in both packages alike
    table = np.asarray(JL.sinusoidal_positions(1500, 1280))[pos]
    ulp = float(np.spacing(np.float32(pos.max())))
    assert np.abs(got.numpy() - table).max() <= ulp
    assert np.abs(want - table).max() <= ulp


def test_m1_prod_step_matches_jax():
    """The prod step at M=1, R=2, D=1, per step: loss, staleness, Σw,
    disagreement and the read plane."""
    jm, jp, tm, _ = model_pair(WHISPER)
    kw = dict(fb_ratio=2, update_delay=1, use_pallas=True)
    jbe = jax_make_backend(
        "prod", "layup", M=1, loss_fn=lambda p, b: jm.loss_fn(p, b,
                                                              block_k=8),
        optimizer=jax_momentum(0.9), schedule=jax_constant(0.05), **kw)
    tbe = make_backend("prod", "layup", M=1, loss_fn=tm.loss_fn,
                       optimizer=momentum(0.9), schedule=constant(0.05),
                       device="cpu", **kw)
    js = jbe.init(jax.random.PRNGKey(0), jp)
    ts = tbe.init(None, np_tree(jp))
    for t in range(2):
        b = {k: v[None] for k, v in _batch(jm.cfg, 4, 8, seed=5 + t).items()}
        js, jmet = jbe.step(js, jax.tree.map(jnp.asarray, b),
                            jax.random.PRNGKey(t))
        ts, tmet = tbe.step(ts, b, None)
        compare_metrics(tmet, jmet, t)
        compare_planes(ts["read"], js["read"], rtol=1e-4)
