"""The port's dense decoder against the JAX package's, from one set of JAX
params carried across with ``repro_torch.convert``.

The JAX init hashes leaf paths with Python's salted ``hash``, so the two
packages are never compared across two inits: one init, converted. Inputs
are made with numpy. Tolerances (float32 on the CPU; XLA and PyTorch sum
matrix products and softmaxes in different orders): loss rtol 1e-5, grads
rtol 1e-4 with an atol of 1e-4 of each leaf's largest gradient.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks.table3_lm import _bench_cfg  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as JLy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core.pytree import tree_leaves  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.models import DecoderLM, build_model  # noqa: E402
from repro_torch.models import layers as TLy  # noqa: E402


def _torch_cfg(jcfg):
    kw = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    kw["dtype"] = torch.float32
    return ModelConfig(**kw)


@pytest.fixture(scope="module")
def problem():
    jcfg = _bench_cfg()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    ds = SyntheticLM(vocab=jcfg.vocab_size, seq_len=32, temperature=1.2,
                     seed=0)
    batch = ds.sample(np.random.default_rng(5), 4)
    return jcfg, jmodel, jparams, batch


def test_decoder_loss_and_grads_match(problem):
    jcfg, jmodel, jparams, batch = problem
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jb, block_k=8), has_aux=True))(jparams)

    model = build_model(_torch_cfg(jcfg))
    tparams = to_torch(jax.tree.map(np.asarray, jparams), "cpu")
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    tloss, aux = model.loss_fn(tparams, to_torch(batch, "cpu"))
    tgrads = torch.autograd.grad(tloss, leaves)

    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    assert float(aux["aux"]) == 0.0
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(tgrads)
    for tg, jg in zip(tgrads, jleaves):
        jg = np.asarray(jg)
        np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-4,
                                   atol=1e-4 * np.abs(jg).max())


def test_module_wrapper_matches_functional_loss(problem):
    jcfg, _, jparams, batch = problem
    model = build_model(_torch_cfg(jcfg))
    tparams = to_torch(jax.tree.map(np.asarray, jparams), "cpu")
    tb = to_torch(batch, "cpu")
    mod = DecoderLM(model, tparams)
    assert sum(p.numel() for p in mod.parameters()) == \
        sum(p.numel() for p in tree_leaves(tparams))
    loss = mod(tb)
    loss.backward()
    assert torch.equal(loss.detach(), model.loss_fn(tparams, tb)[0])
    assert all(p.grad is not None for p in mod.parameters())


@pytest.mark.parametrize("hq,hkv,window", [(4, 4, 0), (4, 2, 0), (4, 1, 5)])
def test_attention_matches_flash_jnp(hq, hkv, window):
    """GQA/MQA and a sliding window: the plain attention against the
    reference's chunked online-softmax (forward and input grads)."""
    rng = np.random.default_rng(hq * 10 + hkv + window)
    B, S, D = 2, 16, 8
    q = rng.standard_normal((B, S, hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, hkv, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    do = rng.standard_normal((B, S, hq, D)).astype(np.float32)

    def jf(q, k, v):
        out = JLy.flash_attention_jnp(q, k, v, q_positions=jnp.asarray(pos),
                                      k_positions=jnp.asarray(pos),
                                      window=window, block_k=4)
        return jnp.sum(out * do), out
    (_, jout), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2),
                                               has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    tout = TLy.attention(tq, tk, tv, q_positions=tpos, k_positions=tpos,
                         window=window)
    tg = torch.autograd.grad((tout * torch.from_numpy(do)).sum(),
                             (tq, tk, tv))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("fraction", [1.0, 0.25])
def test_rope_and_rmsnorm_match(fraction):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8)[None], (2, 8)).astype(np.int32)
    want = JLy.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=1e4,
                          fraction=fraction)
    got = TLy.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                         theta=1e4, fraction=fraction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    g = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        TLy.rmsnorm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
        np.asarray(JLy.rmsnorm(jnp.asarray(x), jnp.asarray(g))),
        rtol=1e-6, atol=1e-6)


def test_decoder_specs_match_reference_tree():
    """The spec tree (paths, shapes, init kinds) is the reference's, so the
    flat partition sees the same three groups at GPT-2 Medium width."""
    from repro.configs import get_config as jax_get_config
    from repro.models.transformer import decoder_specs as jax_specs
    from repro_torch.core.pytree import tree_flatten_with_path
    from repro_torch.models.transformer import decoder_specs

    for name in ("gpt2-medium", "stablelm-1.6b", "granite-8b"):
        tflat, _ = tree_flatten_with_path(decoder_specs(get_config(name)))
        jflat, _ = jax.tree_util.tree_flatten_with_path(
            jax_specs(jax_get_config(name)),
            is_leaf=lambda s: isinstance(s, JLy.ParamSpec))
        assert len(tflat) == len(jflat)
        for (tp, ts), (jp, js) in zip(tflat, jflat):
            assert [getattr(e, "key") for e in tp] == \
                [getattr(e, "key") for e in jp]
            assert (ts.shape, ts.axes, ts.init) == (js.shape, js.axes,
                                                    js.init)
            np.testing.assert_allclose(ts.scale, js.scale, rtol=1e-12)


def test_init_params_shapes_and_statistics():
    cfg = get_config("gpt2-medium").with_(num_layers=2, vocab_size=512)
    model = build_model(cfg)
    p = model.init(seed=3, device="cpu")
    assert tuple(p["blocks"]["sub0"]["attn"]["wq"].shape) == (2, 1024, 16, 64)
    assert torch.equal(p["final_norm"], torch.ones(1024))
    std = p["embed"]["tok"].std().item()
    assert abs(std - 0.02) < 1e-3
    again = model.init(seed=3, device="cpu")
    assert torch.equal(p["embed"]["tok"], again["embed"]["tok"])
