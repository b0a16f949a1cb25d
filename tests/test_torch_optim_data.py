"""The port's optimizers, schedules, synthetic data and configs against the
JAX package's, on the same numpy inputs.

Optimizers run on stacked ``(M, n)`` buffers in the port and per worker
(vmapped) in the JAX package; float32, rtol 1e-6 (XLA may contract
``β·m + g`` into an FMA). Schedules: rtol 1e-6. Data: bit-identical.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import torch_cfg  # noqa: E402

from repro import optim as JO  # noqa: E402
from repro.optim.optimizers import apply_updates as jax_apply_updates  # noqa: E402,E501
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_configs as jax_list_configs  # noqa: E402
from repro.data import synthetic as JS  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.convert import (flatten_to_npz, to_torch,  # noqa: E402
                                 unflatten_npz)
from repro_torch.data import synthetic as TS  # noqa: E402


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"weight_decay": 0.1}),
    ("momentum", {"beta": 0.9}), ("momentum", {"nesterov": True}),
    ("momentum", {"weight_decay": 0.01}),
    ("adamw", {}), ("adamw", {"weight_decay": 0.1})])
def test_optimizers_match(name, kw):
    rng = np.random.default_rng(0)
    M, sizes = 3, {"a": 17, "b": 40}
    params = {k: rng.standard_normal((M, n)).astype(np.float32)
              for k, n in sizes.items()}
    jopt = JO.get_optimizer(name, **kw)
    topt = TO.get_optimizer(name, **kw)
    jstate = jax.vmap(jopt.init)(jax.tree.map(jnp.asarray, params))
    tp = to_torch(params, "cpu")
    tstate = topt.init(tp)
    jp = jax.tree.map(jnp.asarray, params)
    for t in range(3):
        grads = {k: rng.standard_normal((M, n)).astype(np.float32)
                 for k, n in sizes.items()}
        jupd, jstate = jax.vmap(jopt.update, in_axes=(0, 0, 0, None))(
            jax.tree.map(jnp.asarray, grads), jstate, jp, jnp.float32(0.05))
        tupd, tstate = topt.update(to_torch(grads, "cpu"), tstate, tp, 0.05)
        jp = jax_apply_updates(jp, jupd)
        tp = TO.apply_updates(tp, tupd)
        for k in sizes:
            np.testing.assert_allclose(tupd[k].numpy(), np.asarray(jupd[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("tree,max_norm", [
    ({"a": [3.0], "b": [4.0]}, None),      # tests/test_optim.py's norm of 5
    ({"a": [30.0], "b": [40.0]}, 5.0),     # its clip: 50 down to 5
    ({"a": [0.3], "b": [0.4]}, 5.0),       # under the bound: unchanged
    ("random", 2.0)])
def test_global_norm_and_clip_match(tree, max_norm):
    """``global_norm`` and ``clip_by_global_norm`` against the JAX
    package's on the same trees (float32 sums of squares; the scale cast
    to each leaf's dtype, here a bfloat16 leaf too): rtol 1e-6."""
    if tree == "random":
        rng = np.random.default_rng(1)
        tree = {"a": rng.standard_normal((3, 17)).astype(np.float32),
                "b": {"c": rng.standard_normal(40).astype(np.float32)}}
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = to_torch(tree, "cpu")
    np.testing.assert_allclose(
        TO.optimizers.global_norm(ttree).item(),
        float(JO.optimizers.global_norm(jtree)), rtol=1e-6)
    if max_norm is None:
        assert TO.optimizers.global_norm(ttree).item() == pytest.approx(5.0)
        return
    jclip, jn = JO.optimizers.clip_by_global_norm(jtree, max_norm)
    tclip, tn = TO.optimizers.clip_by_global_norm(ttree, max_norm)
    np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    for t, j in zip(jax.tree.leaves(tclip), jax.tree.leaves(jclip)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    assert TO.optimizers.global_norm(tclip).item() == pytest.approx(
        min(max_norm, tn.item()), rel=1e-5)
    bf = {"w": torch.tensor([30.0, 40.0], dtype=torch.bfloat16)}
    clipped, _ = TO.optimizers.clip_by_global_norm(bf, max_norm)
    assert clipped["w"].dtype == torch.bfloat16


def test_schedules_match():
    pairs = [(TO.constant(0.1), JO.constant(0.1)),
             (TO.cosine(0.1, 20, 0.01), JO.cosine(0.1, 20, 0.01)),
             (TO.linear_warmup_cosine(0.1, 5, 30, 0.001),
              JO.linear_warmup_cosine(0.1, 5, 30, 0.001))]
    for tf, jf in pairs:
        for step in (0, 1, 4, 5, 6, 19, 29, 40):
            assert isinstance(tf(step), float)
            np.testing.assert_allclose(tf(step), float(jf(step)), rtol=1e-6,
                                       atol=1e-9)


@pytest.mark.parametrize("args", [(1.0, 0, 100), (0.1, 5, 30, 0.001),
                                  (0.3, 10, 10)])
def test_linear_decay_matches(args):
    tf, jf = TO.linear_decay(*args), JO.linear_decay(*args)
    for step in (0, 1, 4, 5, 6, 9, 10, 11, 29, 30, 50, 100, 120):
        assert isinstance(tf(step), float)
        np.testing.assert_allclose(tf(step), float(jf(step)), rtol=1e-6,
                                   atol=1e-9)


def test_sharded_iterator_matches_jax():
    """The same (seed, step) gives the same batches, bit for bit, on the
    CPU (the port's numpy generators are the JAX package's)."""
    from repro.data.pipeline import ShardedIterator as JaxShardedIterator
    from repro_torch.data import ShardedIterator

    jit = JaxShardedIterator(JS.SyntheticLM(vocab=64, seq_len=8), 2, 4,
                             prefetch=2, seed=3)
    tit = ShardedIterator(TS.SyntheticLM(vocab=64, seq_len=8), 2, 4,
                          prefetch=2, seed=3, device="cpu")
    try:
        for _ in range(3):
            jb, tb = next(jit), next(tit)
            assert sorted(jb) == sorted(tb) == ["labels", "tokens"]
            for k in jb:
                assert tb[k].device.type == "cpu"
                assert tb[k].shape == (2, 4, 8)
                np.testing.assert_array_equal(tb[k].numpy(),
                                              np.asarray(jb[k]))
    finally:
        jit.close()
        tit.close()
    tit._thread.join(timeout=5.0)
    assert not tit._thread.is_alive()


def test_sharded_iterator_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    from repro_torch.data import ShardedIterator
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedIterator(TS.SyntheticLM(vocab=16, seq_len=4), 1, 1)


def test_synthetic_data_bit_identical():
    for kw in (dict(vocab=64, seq_len=12, temperature=1.5, seed=0),
               dict(vocab=128, seq_len=16, temperature=1.2, seed=3)):
        tds, jds = TS.SyntheticLM(**kw), JS.SyntheticLM(**kw)
        assert tds.entropy == jds.entropy
        for step in (0, 7):
            tb = TS.make_worker_batches(tds, 4, 3, step, epoch_seed=1)
            jb = JS.make_worker_batches(jds, 4, 3, step, epoch_seed=1)
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k])
    tv, jv = TS.SyntheticVision(seed=2), JS.SyntheticVision(seed=2)
    tb = TS.make_worker_batches(tv, 2, 5, 3)
    jb = JS.make_worker_batches(jv, 2, 5, 3)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])


def test_dense_configs_and_param_counts_match():
    assert list_configs() == ["gpt2-medium", "gpt2-xl", "granite-8b",
                              "jamba-v0.1-52b", "mamba2-780m",
                              "mixtral-8x7b", "moonshot-v1-16b-a3b",
                              "qwen2-vl-2b", "qwen3-moe-30b-a3b",
                              "stablelm-1.6b", "whisper-large-v3", "yi-34b"]
    assert list_configs() == jax_list_configs()
    for name in list_configs():
        t, j = get_config(name), jax_get_config(name)
        for f in j.__dataclass_fields__:
            if f != "dtype":
                assert getattr(t, f) == getattr(j, f), (name, f)
        assert str(t.dtype).replace("torch.", "") == jnp.dtype(j.dtype).name
        assert t.param_counts() == j.param_counts()


def _assert_builds_as_jax(cfg, jcfg):
    """``cfg`` equals the JAX package's ``jcfg`` field for field, and
    ``build_model`` builds it with the spec tree's paths and shapes of the
    JAX package's model (nothing is allocated)."""
    from repro.models import build_model as jax_build_model
    from repro.models.layers import ParamSpec as JaxParamSpec
    from repro_torch.core.pytree import tree_flatten_with_path
    from repro_torch.models import build_model

    assert cfg == torch_cfg(jcfg)
    tflat, _ = tree_flatten_with_path(build_model(cfg).specs)
    jflat, _ = jax.tree_util.tree_flatten_with_path(
        jax_build_model(jcfg).specs,
        is_leaf=lambda x: isinstance(x, JaxParamSpec))
    assert [([e.key for e in p], s.shape) for p, s in tflat] == \
        [([e.key for e in p], s.shape) for p, s in jflat]


@pytest.mark.parametrize("name", ["qwen2-vl-2b", "jamba-v0.1-52b",
                                  "whisper-large-v3"])
def test_other_families_name_their_roadmap_item(name):
    """The hybrid, VLM and encoder-decoder configs are ported: each equals
    the JAX package's, and its model builds with the JAX package's spec
    tree."""
    _assert_builds_as_jax(get_config(name), jax_get_config(name))


def test_ssm_family_builds():
    """``mamba2-780m`` is ported: its config builds, and so does its
    model's spec tree (nothing is allocated)."""
    from repro_torch.models import build_model
    cfg = get_config("mamba2-780m")
    assert cfg.family == "ssm" and cfg.dtype == torch.bfloat16
    model = build_model(cfg)
    assert set(model.specs["blocks"]["sub0"]) == {"ssm"}
    assert model.specs["blocks"]["sub0"]["ssm"]["in_proj_x"].shape == \
        (48, 1536, 3072)


@pytest.mark.parametrize("kw", [dict(family="hybrid", attn_layer_period=2),
                                dict(frontend="audio"), dict(mrope=True),
                                dict(enc_dec=True), dict(frontend="vision")])
def test_unported_model_features_name_their_roadmap_item(kw):
    """Each model feature of the hybrid, VLM and encoder-decoder families
    builds on a 2-layer GPT-2 Medium as the JAX package's does."""
    _assert_builds_as_jax(
        get_config("gpt2-medium").with_(num_layers=2, **kw),
        jax_get_config("gpt2-medium").with_(num_layers=2, **kw))


def test_convert_roundtrip_keeps_dtypes():
    tree = {"a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "b": np.asarray(jnp.asarray([1.5, -2.25], jnp.bfloat16)),
            "i": np.arange(4, dtype=np.int32)}
    t = to_torch(tree, "cpu")
    assert t["a"]["w"].dtype == torch.float32
    assert t["b"].dtype == torch.bfloat16
    assert t["i"].dtype == torch.int32
    assert t["b"].tolist() == [1.5, -2.25]
    flat = flatten_to_npz({"a": tree["a"], "i": tree["i"]})
    assert sorted(flat) == ["a/w", "i"]
    back = unflatten_npz({"p/" + k: v for k, v in flat.items()}, "p")
    np.testing.assert_array_equal(back["a"]["w"], tree["a"]["w"])
