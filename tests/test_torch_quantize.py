"""The port's int8 error-feedback wire against the JAX package's.

On the CPU the port's dispatch takes the plain PyTorch versions
(``quantize_plane_ref``, ``dequant_mix_ref``); the JAX kernels run in
Pallas interpret mode, as ``tests/test_quantized_wire.py`` runs them, and
beside them the JAX plain versions. Inputs are made with numpy from a seed
and handed to both. Tolerances are those of ``tests/test_quantized_wire.py``:
scales rtol 1e-6 (XLA may fold ``absmax / 127`` into a multiply by the
reciprocal, one ulp); q within one int8 level, since an element whose
``v / s`` sits within an ulp of a half can round the other way under a
scale one ulp apart (at most 1% of the elements may flip; at these sizes
none does, against either JAX version); residuals within one quantization
level of each other; dequant_mix as the JAX kernel tests (f32 1e-5, bf16
2e-2). On this CPU the port's plain quantize_plane also came out bit-equal
to the JAX plain version; the interpret-mode kernel's residuals differ in
the last bits (XLA contracts ``v − q·s`` into an FMA).

The CUDA kernels run only on a card: ``tests/test_torch_gpu.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import quantize as jq  # noqa: E402
from repro.kernels.ref import dequant_mix_ref as jax_dequant_mix_ref  # noqa: E402,E501
from repro.kernels.ref import quantize_plane_ref as jax_quantize_ref  # noqa: E402,E501
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as tq  # noqa: E402
from repro_torch.kernels.ref import dequant_mix_ref, quantize_plane_ref  # noqa: E402,E501

SIZES = [1, 127, 129, 1023, 8 * 128 + 5]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy() if a.dtype != torch.int8 \
            else a.numpy()
    return np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 \
        else np.asarray(a)


def _pair(a, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _plane(n, seed, scale=3.0, M=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if M is None else (M, n)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _deq(q, s, n):
    """q·s per element in f32, as the port lays the rows out."""
    return (q.to(torch.float32)
            * s.repeat_interleave(tq.LANE, dim=-1)[..., :n])


@pytest.mark.parametrize("n", [1, 127, 128, 129, 4101, 33 * 128,
                               (1 << 20) + 3])
def test_layout_and_wire_bytes_equal_jax(n):
    assert tq.quant_layout(n) == jq.quant_layout(n)
    assert tq.quant_layout(n, 64) == jq.quant_layout(n, 64)
    assert tq.quant_wire_nbytes(n) == jq.quant_wire_nbytes(n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SIZES)
def test_quantize_matches_jax(dtype, n):
    jx, tx = _pair(_plane(n, n), dtype)
    jr, tr = _pair(_plane(n, n + 1, scale=0.01), dtype)
    q, s, res = ops.quantize_plane(tx, tr)
    rows = tq.quant_layout(n)[0]
    assert q.dtype == torch.int8 and q.shape == tx.shape
    assert s.dtype == torch.float32 and s.shape == (rows,)
    assert res.dtype == tx.dtype and res.shape == tx.shape
    for name, (jqv, js, jres) in (
            ("pallas", jq.quantize_plane(jx, jr, interpret=True)),
            ("jax ref", jax_quantize_ref(jx, jr))):
        np.testing.assert_allclose(_np(s), _np(js), rtol=1e-6, atol=0,
                                   err_msg=name)
        dq = np.abs(_np(q).astype(np.int32) - _np(jqv).astype(np.int32))
        flips = int((dq > 0).sum())
        assert dq.max() <= 1, f"{name}: q differs by {dq.max()} levels"
        assert flips <= max(1, n // 100), \
            f"{name}: {flips} of {n} int8 levels flipped"
        lvl = float(_np(s).max())
        np.testing.assert_allclose(_np(res), _np(jres), rtol=0,
                                   atol=lvl * 1.01, err_msg=name)


def test_ef_identity_exact_in_f32():
    """``q·s + resid' == x + resid`` bit for bit in float32."""
    n = 8 * 128 + 5
    x = torch.from_numpy(_plane(n, 3, M=3))
    r = torch.from_numpy(_plane(n, 4, scale=0.05, M=3))
    q, s, res = ops.quantize_plane(x, r)
    assert torch.equal(_deq(q, s, n) + res, x + r)
    assert (res.abs() <= s.repeat_interleave(tq.LANE, -1)[:, :n] / 2).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_equals_separate_rows(dtype):
    """Rows never straddle workers: a stacked (M, n) call with n % 128 != 0
    is bit-equal to M separate 1-D calls, and so is dequant_mix with
    per-worker α, β."""
    M, n = 3, 1029
    _, x = _pair(_plane(n, 5, M=M), dtype)
    _, r = _pair(_plane(n, 6, scale=0.02, M=M), dtype)
    _, u = _pair(_plane(n, 7, scale=0.01, M=M), dtype)
    q, s, res = ops.quantize_plane(x, r)
    assert s.shape == (M, tq.quant_layout(n)[0])
    alpha = torch.tensor([0.5, 0.6, 0.7])
    beta = 1.0 - alpha
    q_recv, s_recv = torch.roll(q, 1, 0), torch.roll(s, 1, 0)
    mixed = ops.dequant_mix(x, q_recv, s_recv, u, alpha, beta)
    pure = ops.dequant_mix(x, q_recv, s_recv, None, alpha, beta)
    for m in range(M):
        qm, sm, rm = ops.quantize_plane(x[m], r[m])
        assert torch.equal(q[m], qm) and torch.equal(s[m], sm)
        assert torch.equal(res[m], rm)
        for got, upd in ((mixed, u[m]), (pure, None)):
            want = ops.dequant_mix(x[m], q_recv[m], s_recv[m], upd,
                                   float(alpha[m]), float(beta[m]))
            assert torch.equal(got[m], want)


def test_zero_and_padding_rows():
    """An all-zero row and the padding rows past n get scale 1.0 and q 0;
    the residual there is 0."""
    n = 3 * 128 + 7
    x = torch.from_numpy(_plane(n, 8, M=2))
    x[1, 128:256] = 0.0
    q, s, res = ops.quantize_plane(x, torch.zeros_like(x))
    rows = tq.quant_layout(n)[0]
    assert rows == 32
    assert (s[:, 4:] == 1.0).all()          # padding rows
    assert s[1, 1] == 1.0 and (q[1, 128:256] == 0).all()
    assert (res[1, 128:256] == 0).all()
    assert (s[0, :4] != 1.0).all()
    zq, zs, zr = ops.quantize_plane(torch.zeros(256))
    assert (zq == 0).all() and (zs == 1.0).all() and (zr == 0).all()


def test_out_buffers_and_residual_in_place():
    n = 1029
    x = torch.from_numpy(_plane(n, 9, M=2))
    r = torch.from_numpy(_plane(n, 10, scale=0.05, M=2))
    want = ops.quantize_plane(x, r.clone())
    out_q = torch.empty(x.shape, dtype=torch.int8)
    out_s = torch.empty((2, tq.quant_layout(n)[0]))
    got = ops.quantize_plane(x, r, out_q=out_q, out_s=out_s, out_resid=r)
    assert got[0] is out_q and got[1] is out_s and got[2] is r
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("with_upd", [False, True])
def test_dequant_mix_matches_jax(dtype, n, with_upd):
    jx, tx = _pair(_plane(n, n, scale=2.0), dtype)
    peer = _plane(n, n + 1, scale=2.0)
    jq_, js, _ = jax_quantize_ref(jnp.asarray(peer))
    tq_, ts = torch.from_numpy(np.array(jq_)), torch.from_numpy(
        np.array(js))
    ju, tu = _pair(_plane(n, n + 2, scale=0.01), dtype) if with_upd \
        else (None, None)
    a, b = jnp.float32(0.6), jnp.float32(0.4)
    got = ops.dequant_mix(tx, tq_, ts, tu, 0.6, 0.4)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = dict(rtol=2e-2, atol=1e-4) if dtype == "bfloat16" else \
        dict(rtol=1e-5, atol=1e-6)
    for want in (jq.dequant_mix(jx, jq_, js, ju, a, b, interpret=True),
                 jax_dequant_mix_ref(jx, jq_, js, ju, a, b)):
        np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("with_upd", [False, True])
def test_dequant_mix_per_worker_coefficients_match_jax(with_upd):
    """(M,) α, β over a stacked buffer: row m equals the JAX kernel with
    the scalars α_m, β_m."""
    M, n = 4, 1029
    x, peer, u = (_plane(n, s, M=M) for s in (11, 12, 13))
    w = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    rw = np.roll(w, 1)
    alpha, beta = w / (w + rw), rw / (w + rw)
    q, s, _ = ops.quantize_plane(torch.from_numpy(peer))
    got = ops.dequant_mix(torch.from_numpy(x), q, s,
                          torch.from_numpy(u) if with_upd else None,
                          torch.from_numpy(alpha), torch.from_numpy(beta))
    for m in range(M):
        want = jq.dequant_mix(jnp.asarray(x[m]), jnp.asarray(q[m].numpy()),
                              jnp.asarray(s[m].numpy()),
                              jnp.asarray(u[m]) if with_upd else None,
                              jnp.float32(alpha[m]), jnp.float32(beta[m]),
                              interpret=True)
        np.testing.assert_allclose(_np(got[m]), _np(want), rtol=1e-5,
                                   atol=1e-6)


def test_dequant_mix_bad_scales_raise():
    x = torch.from_numpy(_plane(256, 14))
    q, s, _ = ops.quantize_plane(x)
    with pytest.raises(ValueError, match="scales"):
        ops.dequant_mix(x, q, s[:-1], None, 0.5, 0.5)
    x2 = torch.from_numpy(_plane(256, 15, M=2))
    q2, s2, _ = ops.quantize_plane(x2)
    with pytest.raises(ValueError, match="scales"):
        ops.dequant_mix(x2, q2, s2[0], None, 0.5, 0.5)
    with pytest.raises(ValueError, match="per-worker"):
        ops.dequant_mix(x2, q2, s2, None, torch.ones(3), torch.ones(3))


@pytest.mark.parametrize("n", [257, 1023])
def test_residual_bounded_over_rounds(n):
    """Carrying the residual forward keeps it within the one-round bound
    |r'| ≤ s/2 (no drift), and what is not yet shipped sits in it."""
    x = torch.from_numpy(_plane(n, 16, scale=2.0))
    res = torch.zeros_like(x)
    scale_bound = float(x.abs().max()) / 100.0
    total_in = np.zeros(n, np.float64)
    total_sent = np.zeros(n, np.float64)
    for step in range(5):
        xt = x * (1.0 + 0.1 * step)
        q, s, res = ops.quantize_plane(xt, res)
        assert float(res.abs().max()) <= scale_bound, step
        total_in += xt.numpy().astype(np.float64)
        total_sent += _deq(q, s, n).numpy().astype(np.float64)
    np.testing.assert_allclose(total_in - total_sent, res.numpy(),
                               rtol=1e-4, atol=1e-5)


class TestDispatch:
    def test_cpu_takes_plain_version_and_never_counts(self):
        tq.reset_launches()
        x = torch.from_numpy(_plane(300, 17, M=2))
        q, s, r = ops.quantize_plane(x)
        want = quantize_plane_ref(x)
        assert all(torch.equal(a, b) for a, b in zip((q, s, r), want))
        out = ops.dequant_mix(x, q, s, x, torch.ones(2), torch.zeros(2))
        assert torch.equal(out, dequant_mix_ref(x, q, s, x, torch.ones(2),
                                                torch.zeros(2)))
        assert tq.quantize_launches == 0 and tq.dequant_mix_launches == 0

    def test_other_device_raises(self):
        x = torch.empty(256, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            ops.quantize_plane(x)
        with pytest.raises(ValueError, match="no kernel"):
            ops.dequant_mix(x, x, x, None, 1.0, 0.0)

    def test_kernel_wrappers_reject_cpu_tensors(self):
        x = torch.zeros(256)
        with pytest.raises(ValueError, match="CUDA"):
            tq.quantize_plane(x)
        q, s, _ = quantize_plane_ref(x)
        with pytest.raises(ValueError, match="CUDA"):
            tq.dequant_mix(x, q, s, None, 1.0, 0.0)


def test_chip_smoke_quant_bounds():
    """The bounds ``chip_smoke.py`` reports for one int8 step's quantize
    and dequant passes: GPT-2 Medium at M=4, f32, 13 B an element plus 4 B
    a scale row (7.067 ms at 3.35 TB/s); the pure mix 9 B an element."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    sizes = (402_702_336, 51_463_168, 1024)
    numels = [4 * n for n in sizes]
    rows = [4 * tq.quant_layout(n)[0] for n in sizes]
    assert rows == [12_584_960, 1_608_704, 128]
    ms, by = chip_smoke.quant_bound_ms(numels, rows, 4, "quantize")
    assert by == "bytes"
    np.testing.assert_allclose(
        ms, 1e3 * (sum(numels) * 13 + 4 * sum(rows)) / 3.35e12)
    assert abs(ms - 7.0667) < 1e-3
    dq, _ = chip_smoke.quant_bound_ms(numels, rows, 4, "dequant")
    pure, _ = chip_smoke.quant_bound_ms(numels, rows, 4, "pure")
    assert abs(dq - ms) < 1e-6 and abs(pure - 4.8975) < 1e-3
