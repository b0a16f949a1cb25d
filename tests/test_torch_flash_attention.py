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
    shape (B=2, H=16, S=256, D=64, f32, causal), f32 products at the card's
    3xTF32 tensor-core rate (495/3 = 165 TFLOP/s): the forward's 8,421,376
    bytes take 2.51 us at 3.35 TB/s, above the 1.63 us of its 4·D flops over
    the 32,896 visible pairs a head; the backward's 16,809,984 bytes 5.02 us,
    above 4.09 us of 10·D flops a pair plus delta; the trainable Function's
    944,242,688 flops 5.72 us, above its 5.01 us of bytes."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    assert chip_smoke.attention_pairs(256, 256, True, 0) == 256 * 257 // 2
    assert chip_smoke.attention_pairs(6, 6, True, 2) == 11
    assert chip_smoke.attention_pairs(6, 6, False, 2) == 26
    assert chip_smoke.TF32X3_FLOPS_PER_S == 165e12
    shape = (2, 16, 16, 256, 64, True, 0, 4)
    pairs = 32 * 32896
    ms, by = chip_smoke.attention_bound_ms(*shape, "fwd")
    assert by == "bytes"
    np.testing.assert_allclose(ms, 1e3 * 8_421_376 / 3.35e12)
    assert abs(ms - 2.514e-3) < 1e-6
    assert 1e3 * 4 * 64 * pairs / 165e12 < ms
    ms_b, by_b = chip_smoke.attention_bound_ms(*shape, "bwd")
    assert by_b == "bytes"
    np.testing.assert_allclose(ms_b, 1e3 * 16_809_984 / 3.35e12)
    assert abs(ms_b - 5.018e-3) < 1e-6
    assert 1e3 * (10 * 64 * pairs + 2 * 32 * 256 * 64) / 165e12 < ms_b
    ms_t, by_t = chip_smoke.attention_bound_ms(*shape, "trainable")
    assert by_t == "operations"
    np.testing.assert_allclose(ms_t, 1e3 * 944_242_688 / 165e12)
    assert abs(ms_t - 5.723e-3) < 1e-6
    # bf16 stays on the bf16 tensor-core rate
    ms_h, _ = chip_smoke.attention_bound_ms(*shape[:7], 2, "trainable")
    np.testing.assert_allclose(
        ms_h, max(1e3 * 944_242_688 / 989e12, 1e3 * 8_388_608 / 3.35e12))
    assert chip_smoke.FLASH_MAIN[:5] == (2, 16, 16, 256, 64)


# ---------------------------------------------------------------------------
# The kernels' precision scheme, emulated. float32: every product is an
# mma.sync on TF32 operands with f32 accumulation, in 3xTF32 (x = hi + lo,
# a·b ≈ lo_a·hi_b + hi_a·lo_b + hi_a·hi_b). bfloat16: every product is an
# mma.sync m16n8k16 on bf16 operands with f32 accumulation; Q·Kᵀ and dO·Vᵀ
# take one (both operands bf16, the products exact), and a product with P
# or dS (f32) takes two, P = hi + lo with hi = bf16(P), lo = bf16(P − hi)
# (lo·X first). Here the same splits go into the plain formulas on the CPU
# and must meet chip_smoke.py's gates (FLASH_TOL: 1e-5 of max |plain|
# forward, 1e-4 backward; bf16 adds one bf16 ulp of each element).
# ---------------------------------------------------------------------------

SCHEME_SHAPE = (2, 16, 16, 256, 64)  # B, Hq, Hkv, S, D: the step's call


def _tf32(x):
    """``cvt.rna.tf32.f32``: 10 mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _parts(x, exact):
    """(hi, lo) of x; lo is None for an operand exact in TF32."""
    if exact:
        return x, None
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _bf16_terms(x, terms):
    """x (f32) as ``terms`` bf16 terms, the small one first: [lo, hi] with
    hi = bf16(x) and lo = bf16(x − hi), or [hi]."""
    hi = x.to(torch.bfloat16).float()
    return [hi] if terms == 1 else [(x - hi).to(torch.bfloat16).float(), hi]


def _mm(eq, a, b, a_exact=False, b_exact=False, passes=3, bf16=None):
    """einsum as the kernels' mma.sync products compute it: passes=3 is
    3xTF32 (small terms first), passes=1 one TF32 product; ``bf16`` (the
    bf16 kernels) the number of bf16 terms of a (b is bf16), lo·b first."""
    if bf16 is not None:
        out = torch.zeros(())
        for part in _bf16_terms(a, 1 if a_exact else bf16):
            out = out + torch.einsum(eq, part, b)
        return out
    (ah, al), (bh, bl) = _parts(a, a_exact), _parts(b, b_exact)
    if passes == 1:
        ah, bh = _tf32(a), _tf32(b)
        return torch.einsum(eq, ah, bh)
    out = torch.zeros(())
    if al is not None:
        out = out + torch.einsum(eq, al, bh)
    if bl is not None:
        out = out + torch.einsum(eq, ah, bl)
    return out + torch.einsum(eq, ah, bh)


def _scheme_fwd(q, k, v, exact, passes=3, causal=True, bf16=None):
    """o, lse with the kernels' products; q (B,Hkv,G,Sq,D), k, v
    (B,Hkv,Sk,D) in f32 (values of the working dtype); ``bf16``: the bf16
    kernels' products with P in that many bf16 terms."""
    Sq, Sk, D = q.shape[-2], k.shape[-2], q.shape[-1]
    s = _mm("bhgqd,bhkd->bhgqk", q, k, exact, exact, passes,
            bf16) * D ** -0.5
    s = torch.where(ref._mask(Sq, Sk, causal, 0, q.device), s,
                    torch.full((), ref.NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = _mm("bhgqk,bhkd->bhgqd", p, v, False, exact, passes, bf16) / l
    return o, (m + torch.log(l))[..., 0]


def _scheme_bwd(q, k, v, o, lse, do, exact, causal=True, bf16=None):
    """dq, dk, dv with the kernels' products and delta = rowsum(do·o)."""
    Sq, Sk, D = q.shape[-2], k.shape[-2], q.shape[-1]
    scale = D ** -0.5
    s = _mm("bhgqd,bhkd->bhgqk", q, k, exact, exact, bf16=bf16) * scale
    p = torch.where(ref._mask(Sq, Sk, causal, 0, q.device),
                    torch.exp(s - lse[..., None]), torch.zeros(()))
    delta = (do * o).sum(-1, keepdim=True)
    dp = _mm("bhgqd,bhkd->bhgqk", do, v, exact, exact, bf16=bf16)
    ds = p * (dp - delta)
    dq = _mm("bhgqk,bhkd->bhgqd", ds, k, False, exact, bf16=bf16) * scale
    dk = _mm("bhgqk,bhgqd->bhkd", ds, q, False, exact, bf16=bf16) * scale
    dv = _mm("bhgqk,bhgqd->bhkd", p, do, False, exact, bf16=bf16)
    return dq, dk, dv


def _gate(got, want, tol, ulp=0.0):
    """The largest error as a share of what the gate allows (≤ 1 passes):
    |got − want| ≤ ulp × |want| + tol × max |want| element by element."""
    diff, w = (got.float() - want.float()).abs(), want.float().abs()
    return (diff / (ulp * w + tol * w.max())).max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_precision_scheme_meets_chip_gates(dtype):
    """3xTF32 (f32) or the bf16 kernels' products (one bf16 product, two
    for P and dS) at the main shape: o, lse, dq, dk and dv within the
    gates with a margin; for f32 a single TF32 product would not be."""
    B, Hq, Hkv, S, D = SCHEME_SHAPE
    dt = getattr(torch, dtype)
    exact = dtype == "bfloat16"
    ulp = 2.0 ** -7 if exact else 0.0
    q, k, v, do = (t.to(dt) for t in _t(*_inputs(B, Hq, Hkv, S, D, seed=9)))
    o_r, lse_r = ref.flash_attention_ref(q, k, v)
    want = ref.flash_attention_bwd_ref(q, k, v, o_r, lse_r, do)

    def grouped(x):
        return x.float().reshape(B, Hkv, Hq // Hkv, S, -1)

    qg, og, dog = grouped(q), grouped(o_r), grouped(do)
    kf, vf = k.float(), v.float()
    bf16 = 2 if exact else None
    o, lse = _scheme_fwd(qg, kf, vf, exact, bf16=bf16)
    dq, dk, dv = _scheme_bwd(qg, kf, vf, og, grouped(lse_r[..., None])[..., 0],
                             dog, exact, bf16=bf16)
    shares = {
        "o": _gate(o.reshape(q.shape).to(dt), o_r, 1e-5, ulp),
        "lse": _gate(lse.reshape(lse_r.shape), lse_r, 1e-5),
        "dq": _gate(dq.reshape(q.shape).to(dt), want[0], 1e-4, ulp),
        "dk": _gate(dk.to(dt), want[1], 1e-4, ulp),
        "dv": _gate(dv.to(dt), want[2], 1e-4, ulp),
    }
    assert max(shares.values()) <= (1.0 if exact else 0.25), shares
    if not exact:
        o1, _ = _scheme_fwd(qg, kf, vf, exact, passes=1)
        assert _gate(o1.reshape(q.shape), o_r, 1e-5) > 1.0


# The bf16 families' step shapes (chip_smoke.py FLASH_FAMILIES and the MoE
# step's) cut to B=1 and two kv groups, each keeping its query heads a
# group, D, causal flag and Sq, Sk: (Hq, Hkv, Sq, Sk, D, causal)
BF16_FAMILY_CUTS = {
    "whisper-cross": (2, 2, 256, 1500, 64, False),
    "whisper-encoder": (2, 2, 1500, 1500, 64, False),
    "whisper-decoder": (2, 2, 256, 256, 64, True),
    "jamba": (8, 2, 256, 256, 128, True),
    "qwen2-vl": (12, 2, 256, 256, 128, True),
    "qwen3-moe": (16, 2, 256, 256, 128, True),
}


def _bf16_family_shares(name, terms=2, seed=21):
    """Each output's largest error as a share of its bf16 gate, the bf16
    kernels' products (P and dS in ``terms`` bf16 terms) against the plain
    versions, at a family's cut shape."""
    Hq, Hkv, Sq, Sk, D, causal = BF16_FAMILY_CUTS[name]
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal(
        (1, Hq, Sq, D), dtype=np.float32)).bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal(
        (1, Hkv, Sk, D), dtype=np.float32)).bfloat16() for _ in range(2))
    o_r, lse_r = ref.flash_attention_ref(q, k, v, causal=causal)
    want = ref.flash_attention_bwd_ref(q, k, v, o_r, lse_r, do,
                                       causal=causal)

    def grouped(x):
        return x.float().reshape(1, Hkv, Hq // Hkv, Sq, -1)

    o, lse = _scheme_fwd(grouped(q), k.float(), v.float(), True,
                         causal=causal, bf16=terms)
    dq, dk, dv = _scheme_bwd(grouped(q), k.float(), v.float(), grouped(o_r),
                             grouped(lse_r[..., None])[..., 0], grouped(do),
                             True, causal=causal, bf16=terms)
    ulp = 2.0 ** -7
    return {
        "o": _gate(o.reshape(q.shape).bfloat16(), o_r, 1e-5, ulp),
        "lse": _gate(lse.reshape(lse_r.shape), lse_r, 1e-5),
        "dq": _gate(dq.reshape(q.shape).bfloat16(), want[0], 1e-4, ulp),
        "dk": _gate(dk.bfloat16(), want[1], 1e-4, ulp),
        "dv": _gate(dv.bfloat16(), want[2], 1e-4, ulp),
    }


@pytest.mark.parametrize("name", list(BF16_FAMILY_CUTS))
def test_bf16_scheme_meets_chip_gates_at_family_shapes(name):
    """The bf16 kernels' products (Q·Kᵀ and dO·Vᵀ one bf16 product; P and
    dS two bf16 terms) meet the unchanged bf16 gates at every family's
    cut shape."""
    shares = _bf16_family_shares(name)
    assert max(shares.values()) <= 1.0, shares


def test_bf16_single_term_p_fails_the_o_gate():
    """The control: P (and dS) rounded to one bf16 term, as FlashAttention
    does, exceeds the o gate at Whisper's cross-attention shape, where the
    second term keeps it."""
    assert _bf16_family_shares("whisper-cross", terms=1)["o"] > 1.0


def test_bf16_scheme_matches_pallas():
    """The bf16 scheme against the JAX Pallas kernels in interpret mode on
    the same bf16 inputs (GQA, causal): o and lse to the forward gates,
    dq, dk, dv (from the Pallas forward's o and lse) to the backward's."""
    B, Hq, Hkv, S, D = 1, 4, 2, 128, 64
    q, k, v, do = (x.astype(jnp.bfloat16) for x in map(
        jnp.asarray, _inputs(B, Hq, Hkv, S, D, seed=31)))
    jo, jlse = jax_flash_fwd(q, k, v, causal=True, block_q=64, block_k=64,
                             interpret=True, return_lse=True)
    jd = jax_flash_bwd(q, k, v, jo, jlse, do, causal=True, block_q=64,
                       block_k=64, interpret=True)

    def t(x):
        return torch.from_numpy(np.asarray(x.astype(jnp.float32)))

    def grouped(x):
        return x.reshape(B, Hkv, Hq // Hkv, S, -1)

    qf, kf, vf, dof, jof = map(t, (q, k, v, do, jo))
    o, lse = _scheme_fwd(grouped(qf), kf, vf, True, bf16=2)
    dq, dk, dv = _scheme_bwd(grouped(qf), kf, vf, grouped(jof),
                             grouped(t(jlse)[..., None])[..., 0],
                             grouped(dof), True, bf16=2)
    ulp = 2.0 ** -7
    shares = {
        "o": _gate(o.reshape(qf.shape).bfloat16(), t(jo), 1e-5, ulp),
        "lse": _gate(lse.reshape(B, Hq, S), t(jlse), 1e-5),
        "dq": _gate(dq.reshape(qf.shape).bfloat16(), t(jd[0]), 1e-4, ulp),
        "dk": _gate(dk.bfloat16(), t(jd[1]), 1e-4, ulp),
        "dv": _gate(dv.bfloat16(), t(jd[2]), 1e-4, ulp),
    }
    assert max(shares.values()) <= 1.0, shares


def test_dkv_split_fills_the_card_under_gqa():
    """The bf16 dk/dv grid's split, a pure function of the shape and the
    SM count (132 on an H100): 1 where B·Hkv·ceil(Sk/64) blocks already
    fill the card (Whisper's 20 KV heads) and for float32; past 1 at the
    few-KV-head families, as many parts as keep the grid within one block
    an SM and at most one part for every two (head, query tile)
    iterations."""
    split, bf = fa_kernel.dkv_split, torch.bfloat16
    assert split(2, 20, 20, 256, 1500, bf, 132) == 1   # whisper cross
    assert split(2, 20, 20, 1500, 1500, bf, 132) == 1  # whisper encoder
    assert split(2, 20, 20, 256, 256, bf, 132) == 1    # whisper decoder
    assert split(2, 12, 2, 256, 256, bf, 132) == 8     # qwen2-vl: 16 blocks
    assert split(2, 32, 4, 256, 256, bf, 132) == 4     # qwen3-moe: 32
    assert split(2, 32, 8, 256, 256, bf, 132) == 2     # jamba: 64
    assert split(2, 12, 2, 256, 256, torch.float32, 132) == 1
    assert split(1, 2, 1, 64, 64, bf, 132) == 1        # 2 iterations
    assert split(1, 4, 1, 128, 64, bf, 132) == 4       # 8 iterations
    assert [split(2, 12, 2, 256, 256, bf, 132) for _ in range(3)] == [8] * 3


# ---------------------------------------------------------------------------
# The wrapper's argument lists, through a fake library on CPU tensors
# ---------------------------------------------------------------------------


class _FakeLib:
    """Records each call of the C functions; returns 0 (cudaSuccess)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name not in fa_kernel.SIGNATURES:
            raise AttributeError(name)

        def fn(*args):
            self.calls.append((name, args))
            return 0
        fn.__name__ = name
        return fn


@pytest.fixture
def fake_lib(monkeypatch):
    import contextlib
    lib = _FakeLib()
    monkeypatch.setattr(fa_kernel, "_lib", lambda: lib)
    monkeypatch.setattr(fa_kernel, "_DEVICE", "cpu")
    monkeypatch.setattr(fa_kernel, "_device_stream",
                        lambda device: contextlib.nullcontext(12345))
    return lib


def _check_signature(name, args):
    import ctypes
    sig = fa_kernel.SIGNATURES[name]
    assert len(args) == len(sig), name
    for i, (a, ty) in enumerate(zip(args, sig)):
        assert isinstance(a, int) and not isinstance(a, bool), (name, i, a)
        if ty is ctypes.c_int:
            assert -2 ** 31 <= a < 2 ** 31, (name, i, a)
    assert args[-1] == 12345  # the stream, last


def test_wrapper_argument_lists_match_signatures(fake_lib):
    """Forward one launch, backward exactly two (dq, then dk/dv) that share
    a delta buffer the wrapper allocates and does not fill: it runs no
    operator but allocations. A view with storage offset 1 loses its
    16-byte copy bit; the others keep theirs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    B, Hq, Hkv, S, D = 2, 4, 2, 40, 32
    q, k, v, do = _t(*_inputs(B, Hq, Hkv, S, D, seed=1))
    q_off = torch.empty(q.numel() + 1)[1:].view(q.shape).copy_(q)
    assert q_off.storage_offset() == 1 and not fa_kernel.aligned(q_off)
    assert all(fa_kernel.aligned(t) for t in (q, k, v, do))

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.outs = [], []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.ops.append(str(func.overloadpacket))
            self.outs.append((out.data_ptr(), tuple(out.shape), out.dtype))
            return out

    fa_kernel.reset_launches()
    o, lse = fa_kernel.flash_attention(q_off, k, v, causal=True, window=0)
    (name, args), = fake_lib.calls
    assert name == "flash_attention_fwd"
    _check_signature(name, args)
    assert list(args[:10]) == [0, D, B, Hq, Hkv, S, S, 1, 0, 0b0110]
    assert args[10] == q_off.data_ptr() and args[-2] == lse.data_ptr()

    fake_lib.calls.clear()
    with Ops() as mode:
        dq, dk, dv = fa_kernel.flash_attention_bwd(q, k, v, o, lse, do,
                                                   window=7)
    assert [n for n, _ in fake_lib.calls] == ["flash_attention_bwd_dq",
                                              "flash_attention_bwd_dkv"]
    (_, a_dq), (_, a_dkv) = fake_lib.calls
    for n, a in fake_lib.calls:
        _check_signature(n, a)
        assert list(a[:10]) == [0, D, B, Hq, Hkv, S, S, 1, 7, 0b1111]
    # dq: q, k, v, do, o views, then lse, delta; dk/dv: q, k, v, do, then
    lse_dq, delta_dq = a_dq[30:32]
    lse_dkv, delta_dkv = a_dkv[26:28]
    assert lse_dq == lse_dkv == lse.data_ptr()
    assert delta_dq == delta_dkv
    assert a_dq[26] == o.data_ptr() and a_dq[32] == dq.data_ptr()
    assert a_dkv[28] == dk.data_ptr() and a_dkv[32] == dv.data_ptr()
    assert set(mode.ops) <= {"aten.empty", "aten.empty_like"}, mode.ops
    assert [o[1:] for o in mode.outs if o[0] == delta_dq] == [
        ((B, Hq, S), torch.float32)]
    assert (fa_kernel.fwd_launches, fa_kernel.dq_launches,
            fa_kernel.dkv_launches) == (1, 1, 1)
    fa_kernel.reset_launches()


def test_bf16_split_backward_adds_the_parts(fake_lib, monkeypatch):
    """bf16 at a few KV heads: dq, dk/dv with ``nsplit`` = ``dkv_split``
    and a float32 (2, nsplit, B, Hkv, Sk, D) buffer of partial sums, then
    the summing kernel on that buffer, dk and dv; each counted once, the
    sum on a counter of its own."""
    monkeypatch.setattr(fa_kernel, "sm_count", lambda device: 132)
    B, Hq, Hkv, S, D = 2, 12, 2, 256, 128
    q, k, v, do = (t.bfloat16() for t in _t(*_inputs(B, Hq, Hkv, S, D,
                                                      seed=2)))
    o, lse = q.clone(), torch.zeros(B, Hq, S)
    fa_kernel.reset_launches()
    dq, dk, dv = fa_kernel.flash_attention_bwd(q, k, v, o, lse, do)
    assert [n for n, _ in fake_lib.calls] == [
        "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
        "flash_attention_dkv_sum"]
    (_, a_dq), (_, a_dkv), (_, a_sum) = fake_lib.calls
    for n, a in fake_lib.calls:
        _check_signature(n, a)
    nsplit = fa_kernel.dkv_split(B, Hq, Hkv, S, S, torch.bfloat16, 132)
    assert nsplit == 8 and a_dkv[36] == nsplit and a_dkv[37] != 0
    assert list(a_sum[:7]) == [1, D, B, Hkv, S, nsplit, a_dkv[37]]
    assert a_sum[7] == dk.data_ptr() and a_sum[11] == dv.data_ptr()
    assert (fa_kernel.fwd_launches, fa_kernel.dq_launches,
            fa_kernel.dkv_launches, fa_kernel.dkv_sum_launches) == (
                0, 1, 1, 1)
    fake_lib.calls.clear()
    fa_kernel.flash_attention_bwd(q.float(), k.float(), v.float(), o.float(),
                                  lse, do.float())
    assert [a[36] for n, a in fake_lib.calls
            if n == "flash_attention_bwd_dkv"] == [1]
    assert fa_kernel.dkv_sum_launches == 1
    fa_kernel.reset_launches()


def test_launch_config_reads_the_library(fake_lib):
    """``launch_config`` asks the library for each kernel's block and
    shared memory: kind 0 fwd, 1 dq, 2 dk/dv, with the dtype code and D."""
    cfg = fa_kernel.launch_config(torch.bfloat16, 64)
    assert list(cfg) == list(fa_kernel.KERNELS[torch.bfloat16])
    assert [list(a[:3]) for _, a in fake_lib.calls] == [[0, 1, 64], [1, 1, 64],
                                                  [2, 1, 64]]
    assert all(n == "flash_attention_config" for n, _ in fake_lib.calls)


def test_ptxas_report_parses_registers_and_spills(monkeypatch, tmp_path):
    """``_build.build`` keeps ptxas's ``-v`` lines beside the library, and
    ``_build.ptxas_report`` reads them per kernel without compiling again."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        "echo run >> \"$(dirname \"$0\")/runs\"\n"
        "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
        "touch \"$out\"\n"
        "cat >&2 <<'EOF'\n"
        "ptxas info    : Compiling entry function '_Z3fooIfLi64ELi2EEvv' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooIfLi64ELi2EEvv\n"
        "    16 bytes stack frame, 12 bytes spill stores, 28 bytes spill "
        "loads\n"
        "ptxas info    : Used 255 registers, 1024 bytes smem, used 1 "
        "barriers\n"
        "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 0 barriers\n"
        "EOF\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    lib = _build.build("flash_attention")
    assert lib.exists() and lib.with_suffix(".ptxas").exists()
    assert _build.ptxas_report("flash_attention") == [
        {"function": "_Z3fooIfLi64ELi2EEvv", "registers": 255,
         "static_smem_bytes": 1024, "spill_stores": 12, "spill_loads": 28},
        {"function": "_Z3barv", "registers": 40, "static_smem_bytes": 0,
         "spill_stores": 0, "spill_loads": 0}]
    assert (tmp_path / "runs").read_text().count("run") == 1  # one compile


def test_sass_counts_parse_cuobjdump_output():
    """``_build.parse_sass`` counts each kernel's opcodes from ``cuobjdump
    -sass`` text: the base names of ``SASS_OPS`` (``LDS`` apart from
    ``LDSM``), every HMMA form by its full name, predicated instructions
    included, and only the kernels whose mangled name has the prefix."""
    text = (
        "\tcode for sm_90a\n"
        "\t\tFunction : _ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi64ELi2ELi2E"
        "EEvNS_6ParamsE\n"
        "\t.headerflags\t@\"EF_CUDA_TEXMODE_UNIFIED\"\n"
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;\n"
        "        /*0010*/                   LDSM.16.M88.4 R8, [R3] ;\n"
        "        /*0020*/              @!P0 LDSM.16.MT88.4 R12, [R3+0x80] ;\n"
        "        /*0030*/                   LDS.U16 R4, [R2] ;\n"
        "        /*0040*/                   HMMA.16816.F32.BF16 R20, R8, R12,"
        " R20 ;\n"
        "        /*0050*/                   HMMA.1688.F32.TF32 R24, R8, R12, "
        "R24 ;\n"
        "        /*0060*/                   F2FP.BF16.F32.PACK_AB R5, R6, R7 ;\n"
        "\t\tFunction : _Z3foov\n"
        "        /*0000*/                   HMMA.16816.F32.BF16 R0, R0, R0, "
        "R0 ;\n")
    assert _build.parse_sass(text, "flash") == {
        "_ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi64ELi2ELi2EEEvNS_6ParamsE":
            {"total": 7, "LDSM": 2, "LDS": 1, "HMMA": 2,
             "HMMA.16816.F32.BF16": 1, "HMMA.1688.F32.TF32": 1, "F2FP": 1}}
    assert set(_build.parse_sass(text)) == {
        "_ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi64ELi2ELi2EEEvNS_6ParamsE",
        "_Z3foov"}
