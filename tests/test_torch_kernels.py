"""The port's gossip_mix against the JAX package's Pallas kernel.

On the CPU the port's dispatch takes the plain PyTorch version; the JAX
kernel runs in Pallas interpret mode, as ``tests/test_kernels.py`` runs it.
Inputs are made with numpy from a seed and handed to both. Tolerances:
float32 1e-6 (XLA and PyTorch may contract ``α·x + β·r`` into an FMA
differently: at most an ulp or two per element); bfloat16 2e-2 (one bf16
rounding of the float32 result, as the JAX kernel tests allow).

The Triton kernel itself runs only on a CUDA card: its tests are in
``tests/test_torch_gpu.py``.
"""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.gossip_mix import gossip_mix as jax_gossip_mix  # noqa: E402
from repro_torch.kernels import gossip_mix as gm_kernel  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import gossip_mix_ref  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=1e-6, atol=1e-6)


def _inputs(shape, dtype, seed=0, upd_scale=0.01):
    rng = np.random.default_rng(seed)
    x, r = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    u = (rng.standard_normal(shape) * upd_scale).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a).astype(jdt) for a in (x, r, u)],
            [torch.from_numpy(a).to(tdt) for a in (x, r, u)])


def _np(a):
    return np.asarray(a.to(torch.float32)) if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


class TestGossipMixParity:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", [(128,), (7, 33, 5), (1024, 128),
                                       (3, 3)])
    def test_sweep(self, dtype, shape):
        (jx, jr, ju), (tx, tr, tu) = _inputs(shape, dtype)
        want = jax_gossip_mix(jx, jr, ju, 0.6, 0.4, interpret=True)
        got = ops.gossip_mix(tx, tr, tu, 0.6, 0.4)
        assert got.shape == tx.shape and got.dtype == tx.dtype
        np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n", [1, 127, 129, 1023, 1029])
    def test_odd_sizes(self, dtype, n):
        (jx, jr, ju), (tx, tr, tu) = _inputs((n,), dtype, seed=n)
        want = jax_gossip_mix(jx, jr, ju, 0.7, 0.3, interpret=True)
        got = ops.gossip_mix(tx, tr, tu, 0.7, 0.3)
        assert got.shape == (n,) and got.dtype == tx.dtype
        np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n", [127, 1024])
    def test_pure_variant(self, dtype, n):
        (jx, jr, _), (tx, tr, _) = _inputs((n,), dtype, seed=1)
        want = jax_gossip_mix(jx, jr, None, 0.6, 0.4, interpret=True)
        got = ops.gossip_mix(tx, tr, None, 0.6, 0.4)
        np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))

    def test_pure_mix_convexity(self):
        x = torch.full((64,), 2.0)
        r = torch.full((64,), -1.0)
        out = ops.gossip_mix(x, r, torch.zeros(64), 0.75, 0.25)
        np.testing.assert_allclose(_np(out), 0.75 * 2.0 - 0.25, rtol=1e-6)

    @pytest.mark.parametrize("with_upd", [True, False])
    def test_per_worker_alpha_beta(self, with_upd):
        """(M,) coefficients broadcast over the rows of a stacked (M, n)
        buffer: row i equals the JAX kernel with scalars α_i, β_i."""
        M, n = 4, 1029
        (jx, jr, ju), (tx, tr, tu) = _inputs((M, n), "float32", seed=7)
        w = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
        rw = np.roll(w, 1)
        alpha, beta = w / (w + rw), rw / (w + rw)
        got = ops.gossip_mix(tx, tr, tu if with_upd else None,
                             torch.from_numpy(alpha), torch.from_numpy(beta))
        for i in range(M):
            want = jax_gossip_mix(jx[i], jr[i], ju[i] if with_upd else None,
                                  jnp.float32(alpha[i]), jnp.float32(beta[i]),
                                  interpret=True)
            np.testing.assert_allclose(_np(got[i]), _np(want),
                                       **_tol("float32"))

    def test_bad_coefficient_shape_raises(self):
        x = torch.zeros(4, 8)
        with pytest.raises(ValueError):
            gossip_mix_ref(x, x, None, torch.ones(3), torch.ones(3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gossip_mix_tree_matches_jax(dtype):
    """``ops.gossip_mix_tree`` against the JAX package's
    ``gossip_mix_tree`` (Pallas in interpret mode) on one tree of leaves
    of several shapes; the tolerances of the leaf-wise sweep."""
    from repro.kernels.gossip_mix import gossip_mix_tree as jax_tree

    leaves = [_inputs(shape, dtype, seed=i)
              for i, shape in enumerate([(7, 33, 5), (128,), (3, 3)])]

    def tree(side, n):  # side 0: the JAX arrays, 1: the tensors
        a, c, d = (leaf[side][n] for leaf in leaves)
        return {"a": a, "b": {"c": c, "d": d}}

    jx, jr, ju = (tree(0, n) for n in range(3))
    tx, tr, tu = (tree(1, n) for n in range(3))
    want = jax_tree(jx, jr, ju, 0.6, 0.4, interpret=True)
    gm_kernel.reset_launches()
    got = ops.gossip_mix_tree(tx, tr, tu, 0.6, 0.4)
    assert gm_kernel.launches == 0  # CPU tensors take the plain version
    for g, w, x in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                       jax.tree.leaves(tx)):
        assert g.shape == x.shape and g.dtype == x.dtype
        np.testing.assert_allclose(_np(g), _np(w), **_tol(dtype))


class TestDispatch:
    def test_cpu_takes_plain_version_and_never_counts(self):
        gm_kernel.reset_launches()
        x = torch.randn(3, 100)
        out = ops.gossip_mix(x, x, x, torch.ones(3), torch.zeros(3))
        assert torch.equal(out, x + x)
        assert gm_kernel.launches == 0

    def test_other_device_raises(self):
        """No silent fall back: a tensor that is neither on the CPU nor on
        CUDA has no kernel and raises."""
        x = torch.empty(8, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            ops.gossip_mix(x, x, None, 1.0, 0.0)

    def test_kernel_wrapper_rejects_cpu_tensors(self):
        x = torch.zeros(8)
        with pytest.raises(ValueError, match="CUDA"):
            gm_kernel.gossip_mix(x, x, None, 1.0, 0.0)


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10 and files[-1].exists()
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{f.relative_to(REPO)}: {mod}")
    assert not bad, bad



def test_chip_smoke_bound_counts_every_row():
    """The bound ``chip_smoke.py`` reports for one step's mix: GPT-2 Medium
    at M=4, f32, 16 B per element over 3.35 TB/s (8.68 ms), and the pure
    variant's 12 B per element."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    numels = [4 * 402_702_336, 4 * 51_463_168, 4 * 1024]
    ms, by = chip_smoke.mix_bound_ms(numels, 4, True, 4)
    assert by == "bytes"
    np.testing.assert_allclose(ms, 1e3 * (sum(numels) * 16 + 3 * 4 * 8)
                               / 3.35e12)
    assert abs(ms - 8.6766) < 1e-3
    pure, _ = chip_smoke.mix_bound_ms(numels, 4, False, 4)
    np.testing.assert_allclose(pure / ms, 12 / 16, rtol=1e-6)
