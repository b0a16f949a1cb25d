"""The port's flash attention against the JAX package's Pallas kernels.

On the CPU the port's dispatch takes the plain PyTorch versions
(``repro_torch.kernels.ref``) and its autograd Function runs their forward
and backward formulas; the JAX kernels run in Pallas interpret mode, as
``tests/test_kernels.py`` runs them. Inputs are made with numpy from a seed
and handed to both. Tolerances (float32; XLA and PyTorch sum the score and
value products in different orders): forward o and lse rtol/atol 1e-5,
backward rtol 1e-4 with an atol of 1e-5.

The CUDA C++ kernels run only on a card: their tests are in
``tests/test_torch_gpu.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as jax_flash_fwd, flash_attention_bwd as jax_flash_bwd,
    flash_attention_trainable as jax_flash_trainable)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-5)

# (B, Hq, Hkv, S, D, causal, window, block)
CASES = {
    "mha-causal": (2, 2, 2, 32, 16, True, 0, 16),
    "gqa-causal": (1, 4, 2, 32, 16, True, 0, 16),
    "mqa-causal": (1, 4, 1, 32, 8, True, 0, 8),
    "gqa-window": (2, 4, 2, 64, 16, True, 12, 16),
    "mha-bidirectional": (1, 2, 2, 32, 16, False, 0, 16),
    "mqa-bidirectional-window": (1, 2, 1, 32, 16, False, 8, 16),
}


def _inputs(B, Hq, Hkv, S, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    do = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    return q, k, v, do


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_pallas(name):
    B, Hq, Hkv, S, D, causal, window, blk = CASES[name]
    q, k, v, _ = _inputs(B, Hq, Hkv, S, D, seed=len(name))
    jo, jlse = jax_flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=blk, block_k=blk, interpret=True,
        return_lse=True)
    o, lse = ops.flash_attention(*_t(q, k, v), causal=causal, window=window)
    assert o.shape == (B, Hq, S, D) and lse.shape == (B, Hq, S)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL)
    np.testing.assert_allclose(
        ref.attention_ref(*_t(q, k, v), causal=causal, window=window).numpy(),
        np.asarray(jo), **FWD_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_backward_matches_pallas(name):
    """Both backwards get the same o and lse (the JAX forward's)."""
    B, Hq, Hkv, S, D, causal, window, blk = CASES[name]
    q, k, v, do = _inputs(B, Hq, Hkv, S, D, seed=100 + len(name))
    jo, jlse = jax_flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=blk, block_k=blk, interpret=True,
        return_lse=True)
    want = jax_flash_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jo, jlse,
        jnp.asarray(do), causal=causal, window=window, block_q=blk,
        block_k=blk, interpret=True)
    got = ops.flash_attention_bwd(*_t(q, k, v, np.asarray(jo),
                                      np.asarray(jlse), do),
                                  causal=causal, window=window)
    for g, w, n in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, n
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL,
                                   err_msg=n)


@pytest.mark.parametrize("name", ["gqa-causal", "gqa-window",
                                  "mqa-bidirectional-window"])
def test_trainable_grads_match_jax(name):
    """``torch.autograd.grad`` through the port's Function against
    ``jax.grad`` of the reference's custom_vjp, for a weighted sum."""
    B, Hq, Hkv, S, D, causal, window, blk = CASES[name]
    q, k, v, w = _inputs(B, Hq, Hkv, S, D, seed=7)

    def jf(q, k, v):
        o = jax_flash_trainable(q, k, v, causal=causal,
                                          window=window, block_q=blk,
                                          block_k=blk, interpret=True)
        return jnp.sum(o * w)
    jl, jg = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (x.requires_grad_(True) for x in _t(q, k, v))
    out = ops.flash_attention_trainable(tq, tk, tv, causal=causal,
                                        window=window)
    loss = (out * torch.from_numpy(w)).sum()
    tg = torch.autograd.grad(loss, (tq, tk, tv))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for g, j, n in zip(tg, jg, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **BWD_TOL,
                                   err_msg=n)


def test_trainable_accepts_strided_views():
    """The decoder's (B, S, H, D) tensors go in transposed; the result and
    its grads equal those of contiguous copies."""
    q, k, v, w = _inputs(2, 4, 2, 16, 8, seed=3)
    views = [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))
             .transpose(1, 2).requires_grad_(True) for x in (q, k, v)]
    dense = [x.requires_grad_(True) for x in _t(q, k, v)]
    outs = []
    for args in (views, dense):
        o = ops.flash_attention_trainable(*args, window=5)
        g = torch.autograd.grad((o * torch.from_numpy(w)).sum(), args)
        outs.append((o.detach(), *g))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


class TestDispatch:
    def test_cpu_takes_plain_version_and_never_counts(self):
        fa_kernel.reset_launches()
        q, k, v, do = _t(*_inputs(1, 2, 1, 8, 8, seed=0))
        o, lse = ops.flash_attention(q, k, v)
        ops.flash_attention_bwd(q, k, v, o, lse, do)
        assert (fa_kernel.fwd_launches, fa_kernel.dq_launches,
                fa_kernel.dkv_launches) == (0, 0, 0)

    def test_other_device_raises(self):
        x = torch.empty(1, 1, 8, 32, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            ops.flash_attention(x, x, x)
        with pytest.raises(ValueError, match="no kernel"):
            ops.flash_attention_bwd(x, x, x, x, x[..., 0], x)

    @pytest.mark.parametrize("shape,dtype,match", [
        ((1, 2, 8, 32), torch.float32, "CUDA"),
        ((1, 2, 8, 48), torch.float32, "head dim"),
        ((1, 2, 8, 32), torch.float16, "dtype"),
    ])
    def test_kernel_wrapper_rejects(self, shape, dtype, match):
        x = torch.zeros(shape, dtype=dtype)
        with pytest.raises(ValueError, match=match):
            fa_kernel.flash_attention(x, x, x)

    def test_kernel_wrapper_rejects_mismatched_heads(self):
        q, k = torch.zeros(1, 3, 8, 32), torch.zeros(1, 2, 8, 32)
        with pytest.raises(ValueError, match="multiple"):
            fa_kernel.flash_attention(q, k, k)


class TestBuild:
    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.nvcc()

    def test_library_is_named_by_source_hash(self, monkeypatch, tmp_path):
        """A library whose name carries the source's hash is reused as it
        is: no compiler is looked for."""
        import hashlib
        src = _build.CSRC / "flash_attention.cu"
        digest = hashlib.sha256(src.read_bytes() + " ".join(
            _build.NVCC_FLAGS).encode()).hexdigest()[:16]
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        lib = tmp_path / f"flash_attention-{digest}.so"
        lib.write_bytes(b"")

        def no_nvcc():
            raise AssertionError("rebuilt a current library")
        monkeypatch.setattr(_build, "nvcc", no_nvcc)
        assert _build.build("flash_attention") == lib

    def test_failed_build_raises_with_compiler_output(self, monkeypatch,
                                                      tmp_path):
        fake = tmp_path / "nvcc"
        fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\n"
                        "exit 2\n")
        fake.chmod(0o755)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
        monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
        with pytest.raises(RuntimeError, match="no sm_90a here"):
            _build.build("flash_attention")
        assert not list((tmp_path / "out").glob("*.so"))


def test_chip_smoke_attention_bounds():
    """The bounds ``chip_smoke.py`` reports at the training step's attention
    shape (B=2, H=16, S=256, D=64, f32, causal): forward 4·D flops over the
    32,896 visible pairs a head is 0.27 GFLOP, 4.0 us at 67 TFLOP/s, above
    the 2.5 us for its 8.4 MB; backward 10·D a pair plus delta."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    assert chip_smoke.attention_pairs(256, 256, True, 0) == 256 * 257 // 2
    assert chip_smoke.attention_pairs(6, 6, True, 2) == 11
    assert chip_smoke.attention_pairs(6, 6, False, 2) == 26
    shape = (2, 16, 16, 256, 64, True, 0, 4)
    pairs = 32 * 32896
    ms, by = chip_smoke.attention_bound_ms(*shape, "fwd")
    assert by == "operations"
    np.testing.assert_allclose(ms, 1e3 * 4 * 64 * pairs / 67e12)
    assert abs(ms - 4.022e-3) < 1e-6
    ms_b, by_b = chip_smoke.attention_bound_ms(*shape, "bwd")
    assert by_b == "operations"
    np.testing.assert_allclose(
        ms_b, 1e3 * (10 * 64 * pairs + 2 * 32 * 256 * 64) / 67e12)
    ms_t, _ = chip_smoke.attention_bound_ms(*shape, "trainable")
    np.testing.assert_allclose(ms_t, ms + ms_b, rtol=1e-12)
    assert chip_smoke.FLASH_MAIN[:5] == (2, 16, 16, 256, 64)
