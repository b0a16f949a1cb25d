"""The port's layer partition and flat plane against the JAX package's.

``names``, ``group_sizes`` and ``group_dtypes`` must be equal, and
``pack``/``unpack`` bit-equal, on the same trees carried across as numpy:
the MLP fixture, the ``_bench_cfg`` decoder params, a mixed-dtype tree and a
dict built in non-sorted key order (jax flattens dicts in sorted key order,
torch's own pytree in insertion order; the port must follow jax).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _fixtures import mlp_problem  # noqa: E402
from benchmarks.table3_lm import _bench_cfg  # noqa: E402
from repro.core import layerview as JL  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core import layerview as TL  # noqa: E402
from repro_torch.core.pytree import tree_leaves  # noqa: E402


def _mixed_tree():
    rng = np.random.default_rng(3)
    return {"w": jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16),
            "blocks": [{"a": jnp.asarray(rng.standard_normal(5), jnp.float32),
                        "b": jnp.asarray(rng.standard_normal((2, 3)),
                                         jnp.bfloat16)}
                       for _ in range(2)],
            "norm": {"scale": jnp.asarray(rng.standard_normal(6),
                                          jnp.float32),
                     "w": jnp.asarray(rng.standard_normal((6, 2)),
                                      jnp.bfloat16)}}


def _unsorted_tree():
    rng = np.random.default_rng(4)
    tree = {}
    for k in ("zeta", "alpha", "mid"):  # insertion order != sorted order
        tree[k] = {"y": jnp.asarray(rng.standard_normal((3, 2)), jnp.float32),
                   "x": jnp.asarray(rng.standard_normal(4), jnp.float32)}
    return tree


TREE_NAMES = ("decoder", "mixed", "mlp", "unsorted")


@pytest.fixture(scope="module")
def trees():
    _, mlp = mlp_problem()
    model = build_model(_bench_cfg())
    dec = model.init(jax.random.PRNGKey(0))
    return {"mlp": mlp, "decoder": dec, "mixed": _mixed_tree(),
            "unsorted": _unsorted_tree()}


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("name", TREE_NAMES)
def test_partition_metadata_matches(trees, name):
    jtree = trees[name]
    jp = JL.FlatPartition(jtree)
    tp = TL.FlatPartition(to_torch(_to_np(jtree), "cpu"))
    assert tp.names == jp.names
    assert tp.group_sizes == jp.group_sizes
    assert list(tp.group_sizes) == list(jp.group_sizes)
    assert {k: TL.dtype_name(v) for k, v in tp.group_dtypes.items()} == \
        {k: jnp.dtype(v).name for k, v in jp.group_dtypes.items()}
    assert tp.plane_nbytes() == jp.plane_nbytes() == \
        tp.plane_nbytes(wire="param")
    with pytest.raises(NotImplementedError, match="item 8"):
        tp.plane_nbytes(wire="int8")
    assert tp._index == jp._index


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
@pytest.mark.parametrize("name", TREE_NAMES)
def test_pack_unpack_bit_equal(trees, name, lead):
    jtree = trees[name]
    if lead:
        def stack(x):
            x = np.asarray(x)
            rows = [(x.astype(np.float32) * (i + 1)).astype(x.dtype)
                    for i in range(int(np.prod(lead)))]
            return jnp.asarray(np.stack(rows).reshape(lead + x.shape))
        jtree = jax.tree.map(stack, jtree)
    jp = JL.FlatPartition(jax.tree.map(lambda x: x[(0,) * len(lead)], jtree))
    tp = TL.FlatPartition(to_torch(_to_np(jax.tree.map(
        lambda x: x[(0,) * len(lead)], jtree)), "cpu"))
    ttree = to_torch(_to_np(jtree), "cpu")
    jplane, tplane = jp.pack(jtree), tp.pack(ttree)
    assert list(jplane) == list(tplane)
    for k in jplane:
        assert tplane[k].shape == jplane[k].shape
        assert TL.dtype_name(tplane[k].dtype) == jnp.dtype(jplane[k].dtype).name
        np.testing.assert_array_equal(_f32(tplane[k]), _f32(jplane[k]))
    back_t = tree_leaves(tp.unpack(tplane))
    back_j = jax.tree.leaves(jp.unpack(jplane))
    assert len(back_t) == len(back_j)
    for t, j in zip(back_t, back_j):
        assert tuple(t.shape) == j.shape
        np.testing.assert_array_equal(_f32(t), _f32(j))


def test_pack_into_rows_matches_stacked_pack(trees):
    """``pack(out=)`` writes one worker's row of a stacked plane in place:
    the same buffer as packing the stacked tree."""
    tree = to_torch(_to_np(trees["decoder"]), "cpu")
    tp = TL.FlatPartition(tree)
    M = 3
    stacked = {k: torch.stack([v * (i + 1) for i in range(M)])
               for k, v in tp.pack(tree).items()}
    rows = {k: torch.empty_like(v) for k, v in stacked.items()}
    for i in range(M):
        row_tree = tp.unpack({k: v[i] for k, v in stacked.items()})
        tp.pack(row_tree, out={k: v[i] for k, v in rows.items()})
    for k in stacked:
        assert torch.equal(rows[k], stacked[k])


def test_version_clock_arithmetic_matches():
    rng = np.random.default_rng(0)
    versions = rng.uniform(0, 3, (4, 5)).astype(np.float32)
    for G in (1, 3, 5):
        np.testing.assert_array_equal(TL.send_fractions(G),
                                      JL.send_fractions(G))
    value = np.float32(2.0) + TL.send_fractions(5)
    jv = JL.stamp_groups(jnp.asarray(versions), jnp.asarray(value))
    tv = TL.stamp_groups(torch.from_numpy(versions), torch.from_numpy(value))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for step in (0, 2, 7):
        jm = JL.version_metrics(jnp.asarray(versions), step)
        tm = TL.version_metrics(torch.from_numpy(versions), step)
        for k in jm:
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-6)

