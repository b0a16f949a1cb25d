"""The port's plain ``ssd_scan`` and ``rmsnorm`` (``kernels/ref.py``, reached
through ``kernels.ops`` on CPU tensors) against the JAX package's Pallas
kernels in interpret mode and its plain oracles, on every case of
``tests/test_kernels.py``'s ``TestSSDKernel`` and ``TestRMSNormKernel``,
in float32 and bfloat16.

Inputs are made with numpy from a seed, in float32, and rounded to
bfloat16 by each framework (both round to nearest even, so both see the
same bits). Tolerances are the JAX test's ``_tol``: float32 rtol 2e-4 /
atol 2e-5, bfloat16 2e-2 / 2e-2.
"""
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as TLy  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else \
        dict(rtol=2e-4, atol=2e-5)


def _both(a, name, cast=True):
    """One float32 numpy array as a JAX array and a CPU tensor, each cast
    to the case's dtype (``cast=False``: kept float32)."""
    jdt, tdt = DTYPES[name] if cast else (jnp.float32, torch.float32)
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,S,P,N,chunk", [
    (1, 2, 32, 8, 4, 8),
    (2, 3, 64, 16, 8, 16),
    (1, 1, 64, 32, 16, 64),
])
def test_ssd_scan_matches_jax(dtype, B, H, S, P, N, chunk):
    """TestSSDKernel's cases and distributions (A stays float32)."""
    rng = np.random.default_rng(B * 1000 + H * 100 + S + P + N)
    f = np.float32
    x = (rng.standard_normal((B, H, S, P)) * 0.5).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((B, H, S)))).astype(f)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(f)
    Bm = (rng.standard_normal((B, S, N)) * 0.5).astype(f)
    Cm = (rng.standard_normal((B, S, N)) * 0.5).astype(f)
    (jx, tx), (jdt, tdt), (jb, tb), (jc, tc) = (
        _both(a, dtype) for a in (x, dt, Bm, Cm))
    jA, tA = _both(A, dtype, cast=False)
    got = ops.ssd_scan(tx, tdt, tA, tb, tc, chunk=chunk)
    assert got.shape == (B, H, S, P) and got.dtype == DTYPES[dtype][1]
    kernel = jops.ssd_scan(jx, jdt, jA, jb, jc, chunk=chunk, interpret=True)
    oracle = jref.ssd_ref(jx, jdt, jA, jb, jc)
    for name, want in (("Pallas kernel", kernel), ("ssd_ref", oracle)):
        np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype),
                                   err_msg=f"port vs JAX {name}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,tile", [((4, 64), 2), ((2, 7, 128), 8),
                                        ((300, 32), 256)])
def test_rmsnorm_matches_jax(dtype, shape, tile):
    """TestRMSNormKernel's cases; ``tile_rows`` is passed to both and
    ignored by the port."""
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(shape[-1:])).astype(np.float32)
    (jx, tx), (jg, tg) = _both(x, dtype), _both(g, dtype)
    got = ops.rmsnorm(tx, tg, tile_rows=tile)
    assert got.shape == shape and got.dtype == DTYPES[dtype][1]
    kernel = jops.rmsnorm(jx, jg, tile_rows=tile, interpret=True)
    oracle = jref.rmsnorm_ref(jx, jg)
    for name, want in (("Pallas kernel", kernel), ("rmsnorm_ref", oracle)):
        np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype),
                                   err_msg=f"port vs JAX {name}")


def test_rmsnorm_is_the_model_norm():
    """On the CPU ``ops.rmsnorm`` is exactly the norm the model runs."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 64)).astype(np.float32))
    g = torch.linspace(0.5, 1.5, 64)
    assert torch.equal(ops.rmsnorm(x, g), TLy.rmsnorm(x, g))


def test_ssd_scan_rejects_a_chunk_that_does_not_divide_s():
    x = torch.zeros(1, 2, 64, 8)
    with pytest.raises(ValueError, match="divide"):
        ops.ssd_scan(x, torch.zeros(1, 2, 64), torch.zeros(2),
                     torch.zeros(1, 64, 4), torch.zeros(1, 64, 4), chunk=24)


@pytest.mark.parametrize("op", ["rmsnorm", "ssd_scan"])
def test_other_devices_raise(op):
    """Neither a CPU nor a CUDA tensor: no kernel, no plain fall back."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        if op == "rmsnorm":
            ops.rmsnorm(torch.empty(4, 8, **meta), torch.empty(8, **meta))
        else:
            ops.ssd_scan(torch.empty(1, 2, 8, 4, **meta),
                         torch.empty(1, 2, 8, **meta),
                         torch.empty(2, **meta), torch.empty(1, 8, 4, **meta),
                         torch.empty(1, 8, 4, **meta))


def test_kernel_modules_import_without_nvcc(monkeypatch):
    """Importing the wrappers builds nothing: ``nvcc`` runs at the first
    launch on a CUDA tensor only."""
    from repro_torch.kernels import _build

    def no_nvcc():
        raise AssertionError("nvcc was asked for at import")

    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    loaded = dict(_build._LIBS)
    for name in ("rmsnorm", "ssd_scan"):
        mod = importlib.reload(importlib.import_module(
            f"repro_torch.kernels.{name}"))
        assert mod.launches == 0
        assert name in _build.SOURCES
    assert _build._LIBS == loaded


def test_chip_smoke_ssd_bound_counts_cb_once_per_chunk():
    """``chip_smoke.py``'s ``ssd_scan`` bound at the Mamba2 step's shape
    (B=2, H=48, S=256, P=64, N=128, chunk 128) counts the function's work:
    C·Bᵀ once a (b, chunk), since Bm and Cm are shared across heads, 1.0246
    GFLOP (the TPU kernel recomputes C·Bᵀ for every head). The bound
    counts what y needs of it: C·state from chunk 1 on (chunk 0 starts
    from a zero state), the ingest up to the last chunk but one (the last
    state is never read), the state's decay only where a state is carried
    past chunk 1, so 0.619 GFLOP at this shape. Each kind of work runs at
    its unit's rate: C·Bᵀ of bf16 operands on the bf16 tensor cores, W·x,
    C·state and the ingest (one f32 operand, one bf16, exact in TF32) at
    the 2xTF32 rate, in f32 every product at the 3xTF32 rate, the decay
    weights at the f32 rate: 2.53 us in bf16, where all of the function's
    work at the f32 rate would be 15.3 us; f32 is bound by its bytes."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    B, H, S, P, N, Q = chip_smoke.SSD_MAIN
    assert (B, H, S, P, N, Q) == (2, 48, 256, 64, 128, 128)
    T, nc = int(np.tril(np.ones((Q, Q))).sum()), S // Q
    cb = 2 * T * N * B * nc
    products = B * H * nc * (2 * T * P + 4 * Q * N * P)
    elementwise = B * H * nc * (3 * T + 2 * N * P)
    assert chip_smoke.ssd_flops(B, H, S, P, N, Q) == (
        cb + products + elementwise)
    assert chip_smoke.ssd_flops(B, H, S, P, N, Q, per_head_cb=True) == (
        H * cb + products + elementwise)
    # what y needs: C·state over chunks 1 .. nc-1, the ingest over 0 ..
    # nc-2, the state's decay over 1 .. nc-2 (none at two chunks)
    needed = (B * H * (nc * 2 * T * P + 2 * (nc - 1) * 2 * Q * N * P),
              B * H * (nc * 3 * T + max(nc - 2, 0) * 2 * N * P))
    assert nc == 2 and needed[0] == 605_552_640
    ms, by = chip_smoke.ssd_bound_ms(B, H, S, P, N, Q, 2, 4)
    assert by == "operations"
    np.testing.assert_allclose(ms, 1e3 * (cb / 989e12 + needed[0] / 247.5e12
                                          + needed[1] / 67e12))
    assert abs(ms - 2.526e-3) < 1e-6
    # f32 operands: every product at the 3xTF32 rate; bytes bound it
    ms32, by32 = chip_smoke.ssd_bound_ms(B, H, S, P, N, Q, 4, 4)
    assert by32 == "bytes"
    assert ms32 > 1e3 * ((cb + needed[0]) / 165e12 + needed[1] / 67e12)
    nbytes = 2 * B * H * S * P * 4 + B * H * S * 4 + 4 * H + 2 * B * S * N * 4
    np.testing.assert_allclose(ms32, 1e3 * nbytes / 3.35e12)
