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

from repro import optim as JO  # noqa: E402
from repro.optim.optimizers import apply_updates as jax_apply_updates  # noqa: E402,E501
from repro.configs import get_config as jax_get_config  # noqa: E402
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
                              "stablelm-1.6b", "yi-34b"]
    for name in list_configs():
        t, j = get_config(name), jax_get_config(name)
        for f in j.__dataclass_fields__:
            if f != "dtype":
                assert getattr(t, f) == getattr(j, f), (name, f)
        assert str(t.dtype).replace("torch.", "") == jnp.dtype(j.dtype).name
        assert t.param_counts() == j.param_counts()


@pytest.mark.parametrize("name", ["mixtral-8x7b", "mamba2-780m",
                                  "whisper-large-v3"])
def test_other_families_name_their_roadmap_item(name):
    jax_get_config(name)  # exists in the JAX package
    with pytest.raises(NotImplementedError, match="item 14"):
        get_config(name)


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
