"""The port's checkpoints against the JAX package's: the archive's keys
are ``jax.tree_util.keystr`` strings, so an ``.npz`` written by either
package restores in the other; bf16 round-trips through f32; ``like``'s
dtypes and devices are kept; a prod state saved and restored resumes bit
for bit (the chip phase ``checkpoint``, at the MLP fixture's size)."""
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _fixtures import mlp_batch  # noqa: E402
from _torch_parity import mlp_params, np_tree, torch_mlp_loss  # noqa: E402
from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro_torch.checkpoint import (latest_step,  # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint.checkpoint import keystr  # noqa: E402
from repro_torch.core.pytree import (tree_flatten_with_path,  # noqa: E402
                                     tree_leaves, tree_map)


def _jax_state(rng):
    return {
        "params": {"w": jax.random.normal(rng, (4, 4)),
                   "layers": (jnp.ones((2, 3)), jnp.zeros(5))},
        "weights": jnp.full((8,), 0.125),
        "step": jnp.asarray(17, jnp.int32),
        "opt": {"mu": jnp.ones((4, 4), jnp.bfloat16) * 1.5},
    }


def _state(rng):
    """The same state in the port's tensors."""
    j = _jax_state(rng)
    out = tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)
                                              if a.dtype == jnp.bfloat16
                                              else np.array(a)), j)
    out["opt"]["mu"] = out["opt"]["mu"].to(torch.bfloat16)
    return out


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


def test_round_trip(tmp_path, rng):
    st = _state(rng)
    save_checkpoint(str(tmp_path), 17, st)
    restored = restore_checkpoint(str(tmp_path), 17,
                                  tree_map(torch.zeros_like, st))
    _equal(restored, st)
    assert restored["opt"]["mu"].dtype == torch.bfloat16


def test_latest_step(tmp_path, rng):
    st = _state(rng)
    assert latest_step(str(tmp_path)) is None
    save_checkpoint(str(tmp_path), 5, st)
    save_checkpoint(str(tmp_path), 50, st)
    assert latest_step(str(tmp_path)) == 50
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000005.npz",
                                            "ckpt_00000050.npz"]
    restored = restore_checkpoint(str(tmp_path), None,
                                  tree_map(torch.zeros_like, st))
    assert int(restored["step"]) == 17
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), None, st)


def test_missing_leaf_raises_and_fill_missing_keeps_like(tmp_path, rng):
    st = _state(rng)
    save_checkpoint(str(tmp_path), 1, st)
    with pytest.raises(KeyError, match="extra"):
        restore_checkpoint(str(tmp_path), 1, dict(st, extra=torch.zeros(3)))
    bigger = dict(st, versions=torch.full((8, 2), 7.0))
    restored = restore_checkpoint(str(tmp_path), 1, bigger,
                                  fill_missing=True)
    assert torch.equal(restored["versions"], torch.full((8, 2), 7.0))
    assert torch.equal(restored["params"]["w"], st["params"]["w"])


def test_keys_are_jax_keystr(rng):
    j = _jax_state(rng)
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(j)[0]]
    got = [keystr(p) for p, _ in tree_flatten_with_path(_state(rng))[0]]
    assert got == want
    assert "['params']['layers'][0]" in got


def test_jax_archive_restores_in_the_port(tmp_path, rng):
    j = _jax_state(rng)
    jax_save(str(tmp_path), 3, j)
    restored = restore_checkpoint(str(tmp_path), 3,
                                  tree_map(torch.zeros_like, _state(rng)))
    _equal(restored, _state(rng))


def test_port_archive_restores_in_jax(tmp_path, rng):
    save_checkpoint(str(tmp_path), 4, _state(rng))
    j = _jax_state(rng)
    restored = jax_restore(str(tmp_path), 4, jax.tree.map(jnp.zeros_like, j))
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(j)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_numpy_and_host_leaves(tmp_path):
    """Leaves that are numpy arrays (the membership mask) restore as numpy
    in ``like``'s dtype; python scalars as arrays, as the reference's."""
    st = {"alive": np.ones(3, np.float32), "n": 5,
          "x": torch.arange(4, dtype=torch.int64)}
    save_checkpoint(str(tmp_path), 0, st)
    like = {"alive": np.zeros(3, np.float32), "n": 0,
            "x": torch.zeros(4, dtype=torch.int64)}
    got = restore_checkpoint(str(tmp_path), 0, like)
    assert isinstance(got["alive"], np.ndarray)
    np.testing.assert_array_equal(got["alive"], st["alive"])
    assert int(got["n"]) == 5 and torch.equal(got["x"], st["x"])


def _prod(M, **kw):
    from repro_torch.core.backend import make_backend
    from repro_torch.optim import constant, momentum

    return make_backend("prod", "layup", M=M, loss_fn=torch_mlp_loss,
                        optimizer=momentum(0.9), schedule=constant(0.05),
                        fb_ratio=2, update_delay=1, use_pallas=True,
                        device="cpu", **kw)


@pytest.mark.parametrize("M", [1, 4])
def test_prod_state_resumes_bit_for_bit(tmp_path, M):
    """Save the prod state (read, write, momentum, FIFO) after two steps,
    restore it into a fresh ``init`` state: the planes are equal, and two
    more steps from either (the restored one after ``resume(2)``, which
    also replays the host's gossip-shift draws at M=4) give the same
    metrics and planes."""
    batches = [np_tree(mlp_batch(t, M=M, b=8)) for t in range(4)]
    be = _prod(M=M)
    st = be.init(None, mlp_params())
    for b in batches[:2]:
        st, _ = be.step(st, b)
    save_checkpoint(str(tmp_path), 2, st)
    be2 = _prod(M=M)
    fresh = be2.init(None, mlp_params())
    back = restore_checkpoint(str(tmp_path), 2, fresh)
    _equal(back, st)
    be2.resume(2)

    def run(backend, state):
        hist = []
        for b in batches[2:]:
            state, m = backend.step(state, b)
            hist.append([float(m[k]) for k in ("loss", "weight_sum",
                                                 "update_staleness")])
        return hist, state

    h1, s1 = run(be, st)
    h2, s2 = run(be2, back)
    assert h1 == h2
    _equal(s1, s2)
