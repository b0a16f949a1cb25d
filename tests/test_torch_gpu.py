"""Tests of the port that need a CUDA card (marker ``gpu``); they skip
without one. This file imports neither jax nor the JAX package, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import os

import pytest

# cuBLAS gives the same bits on every CUDA stream only with a fixed
# workspace; set before CUDA starts (the engine tests compare streams)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

torch = pytest.importorskip("torch")

from repro_torch.kernels import gossip_mix as gm_kernel  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import gossip_mix_ref  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,n", [(torch.float32, 1), (torch.float32, 129),
                                     (torch.float32, 1 << 20),
                                     (torch.bfloat16, 1029)])
def test_triton_kernel_matches_plain_version(cuda_device, dtype, n):
    """Both variants against ``gossip_mix_ref`` on the same CUDA tensors.
    float32 to 1e-6 (FMA contraction differs by an ulp), bf16 to 2e-2."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x, r, u = (torch.randn((4, n), generator=gen, device=cuda_device)
               .to(dtype) for _ in range(3))
    a = torch.tensor([0.5, 0.6, 0.7, 0.8], device=cuda_device)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else \
        dict(rtol=1e-6, atol=1e-6)
    before = gm_kernel.launches
    for upd in (u, None):
        got = ops.gossip_mix(x, r, upd, a, 1 - a)
        want = gossip_mix_ref(x, r, upd, a, 1 - a)
        torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.cuda.synchronize()
    assert gm_kernel.launches == before + 2


@pytest.mark.gpu
def test_fused_m1_is_exact_apply(cuda_device):
    """α=1, β=0 with x_recv = x is ``x + upd`` bit for bit (the M=1 route)."""
    x = torch.randn(1, 4096, device=cuda_device)
    u = torch.randn(1, 4096, device=cuda_device) * 1e-3
    one, zero = torch.ones(1, device=cuda_device), \
        torch.zeros(1, device=cuda_device)
    assert torch.equal(ops.gossip_mix(x, x, u, one, zero), x + u)
    want = x + u
    assert ops.gossip_mix(x, x, u, one, zero, out=x) is x  # in place
    assert torch.equal(x, want)


# ---------------------------------------------------------------------------
# flash attention (CUDA C++)
# ---------------------------------------------------------------------------

from repro_torch.kernels import flash_attention as fa_kernel  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_bwd_ref,  # noqa: E402
                                     flash_attention_ref)

# (B, Hq, Hkv, S, D, causal, window, dtype): the training step's shape,
# GQA, MQA, windows, bidirectional, D=32/128, S not a multiple of the tile
FLASH_CASES = [
    (2, 16, 16, 256, 64, True, 0, torch.float32),
    (1, 8, 2, 200, 64, True, 0, torch.float32),
    (1, 8, 1, 130, 32, True, 48, torch.float32),
    (2, 4, 4, 96, 128, False, 0, torch.float32),
    (1, 4, 2, 77, 64, False, 20, torch.float32),
    (2, 8, 2, 256, 64, True, 0, torch.bfloat16),
    (1, 4, 4, 100, 128, True, 32, torch.bfloat16),
]


def _flash_tol(dtype, bwd):
    """float32: the kernels sum in another order than cuBLAS (1e-5 of the
    largest value forward, 1e-4 backward); bfloat16 adds one bf16 ulp of
    each element (2^-7 x |plain|), since each side is one rounding of a
    float32 result within that tolerance."""
    return dict(tol=1e-4 if bwd else 1e-5,
                ulp=2.0 ** -7 if dtype == torch.bfloat16 else 0.0)


def _close(got, want, name, *, tol, ulp=0.0, scale=None):
    """|got − want| ≤ ulp × |want| + tol × max |want|, element by element
    (``scale`` in place of max |want| where given)."""
    diff, ref = (got.float() - want.float()).abs(), want.float().abs()
    excess = (diff - ulp * ref - tol * (ref.max() if scale is None
                                        else scale)).max().item()
    assert excess <= 0, (f"{name}: error exceeds {ulp} x |want| + {tol} x "
                         f"max |want| by {excess}")


def _decoder_layout(gen, B, H, S, D, dtype, dev):
    """(B, H, S, D) views of (B, S, H, D) tensors, as the decoder passes."""
    return torch.randn((B, S, H, D), generator=gen, device=dev).to(
        dtype).transpose(1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_kernels_match_plain_version(cuda_device, case):
    B, Hq, Hkv, S, D, causal, window, dtype = case
    gen = torch.Generator(device=cuda_device).manual_seed(S + D)
    q = _decoder_layout(gen, B, Hq, S, D, dtype, cuda_device)
    k, v = (_decoder_layout(gen, B, Hkv, S, D, dtype, cuda_device)
            for _ in range(2))
    do = _decoder_layout(gen, B, Hq, S, D, dtype, cuda_device)
    kw = dict(causal=causal, window=window)
    before = (fa_kernel.fwd_launches, fa_kernel.dq_launches,
              fa_kernel.dkv_launches)
    o, lse = fa_kernel.flash_attention(q, k, v, **kw)
    o_ref, lse_ref = flash_attention_ref(q, k, v, **kw)
    _close(o, o_ref, "o", **_flash_tol(dtype, False))
    _close(lse, lse_ref, "lse", tol=1e-5)
    assert o.stride() == q.stride() and lse.is_contiguous()
    grads = fa_kernel.flash_attention_bwd(q, k, v, o_ref, lse_ref, do, **kw)
    want = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
    for g, w, n in zip(grads, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape and g.dtype == w.dtype, n
        _close(g, w, n, **_flash_tol(dtype, True))
    torch.cuda.synchronize()
    assert (fa_kernel.fwd_launches, fa_kernel.dq_launches,
            fa_kernel.dkv_launches) == tuple(n + 1 for n in before)


def _flash_pair(q, k, v, do, kw):
    """The kernels' (o, lse, dq, dk, dv) and the plain versions', the
    backward of both from the plain forward's o and lse."""
    o, lse = fa_kernel.flash_attention(q, k, v, **kw)
    o_ref, lse_ref = flash_attention_ref(q, k, v, **kw)
    grads = fa_kernel.flash_attention_bwd(q, k, v, o_ref, lse_ref, do, **kw)
    want = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
    torch.cuda.synchronize()
    return (o, lse, *grads), (o_ref, lse_ref, *want)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [2048, 65, 1])
def test_flash_kernels_long_and_short_sequences(cuda_device, S):
    """S=2048 f32 causal: 32 trips round the K/V ring; S=65: one full tile
    and a ragged one; S=1: one row and one key. At S=1 the softmax has one
    key, so dq and dk are 0 in exact arithmetic and both sides are rounding
    noise of dP − delta: they are held to tol × max |dP| (here |dP| =
    |do·v|), the scale of that noise, instead of max |plain| ~ 1e-6."""
    gen = torch.Generator(device=cuda_device).manual_seed(S)
    B, Hq, Hkv, D = (1, 4, 2, 64) if S > 1 else (2, 4, 2, 64)
    q, do = (_decoder_layout(gen, B, Hq, S, D, torch.float32, cuda_device)
             for _ in range(2))
    k, v = (_decoder_layout(gen, B, Hkv, S, D, torch.float32, cuda_device)
            for _ in range(2))
    got, want = _flash_pair(q, k, v, do, dict(causal=True))
    dp = (do.reshape(B, Hkv, Hq // Hkv, S, D).float()
          * v[:, :, None].float()).sum(-1).abs().max()
    for n, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        bwd = n.startswith("d")
        scale = dp if S == 1 and n in ("dq", "dk") else None
        _close(g, w, n, tol=1e-4 if bwd else 1e-5, scale=scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_take_misaligned_views(cuda_device, dtype):
    """Views with a storage offset of 1 element and a sequence stride of
    H·D + 3 elements take the element-by-element copies inside the same
    kernels (no operand is 16-byte aligned) and match the plain version."""
    B, Hq, Hkv, S, D = 2, 8, 2, 200, 64
    gen = torch.Generator(device=cuda_device).manual_seed(11)

    def view(H):
        row = H * D + 3
        buf = torch.randn(B * S * row + 1, generator=gen,
                          device=cuda_device).to(dtype)
        return buf.as_strided((B, S, H, D), (S * row, row, D, 1),
                              1).transpose(1, 2)

    q, k, v, do = view(Hq), view(Hkv), view(Hkv), view(Hq)
    assert not any(fa_kernel.aligned(t) for t in (q, k, v, do))
    got, want = _flash_pair(q, k, v, do, dict(causal=True))
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    for n, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        _close(g, w, n, tol=1e-4 if n.startswith("d") else 1e-5,
               ulp=0.0 if n == "lse" else ulp)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [FLASH_CASES[0], FLASH_CASES[5]], ids=str)
def test_flash_kernels_are_deterministic(cuda_device, case):
    """Two calls on the same inputs give bit-identical o, lse, dq, dk and
    dv: the backward sums in a fixed order, with no atomics."""
    B, Hq, Hkv, S, D, causal, window, dtype = case
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, do = (_decoder_layout(gen, B, Hq, S, D, dtype, cuda_device)
             for _ in range(2))
    k, v = (_decoder_layout(gen, B, Hkv, S, D, dtype, cuda_device)
            for _ in range(2))
    kw = dict(causal=causal, window=window)
    runs = []
    for _ in range(2):
        o, lse = fa_kernel.flash_attention(q, k, v, **kw)
        runs.append((o, lse) + fa_kernel.flash_attention_bwd(
            q, k, v, o, lse, do, **kw))
    torch.cuda.synchronize()
    for n, a, b in zip(("o", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), n


@pytest.mark.gpu
def test_flash_trainable_and_decoder_routes_agree(cuda_device):
    """The autograd Function on the card against the plain forward and
    backward; then a 2-layer decoder's loss and grads through the kernel
    route against the plain route (``USE_PALLAS=False``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_flatten, tree_unflatten
    from repro_torch.models import build_model
    from repro_torch.models import layers as TLy

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q = _decoder_layout(gen, 2, 8, 96, 64, torch.float32, cuda_device)
    k, v = (_decoder_layout(gen, 2, 2, 96, 64, torch.float32, cuda_device)
            for _ in range(2))
    w = torch.randn(q.shape, generator=gen, device=cuda_device)
    args = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention_trainable(*args, window=40)
    grads = torch.autograd.grad((out * w).sum(), args)
    o_ref, lse_ref = flash_attention_ref(q, k, v, window=40)
    _close(out, o_ref, "o", tol=1e-5)
    for g, r, n in zip(grads, flash_attention_bwd_ref(
            q, k, v, o_ref, lse_ref, w, window=40), "qkv"):
        _close(g, r, f"d{n}", tol=1e-4)

    cfg = get_config("gpt2-medium").with_(num_layers=2, vocab_size=512)
    model = build_model(cfg)
    params = model.init(seed=0, device=cuda_device)
    toks = torch.randint(0, 512, (2, 129), generator=gen, device=cuda_device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    results = []
    for use in (True, False):
        TLy.USE_PALLAS = use
        try:
            flat, treedef = tree_flatten(params)
            leaves = [p.detach().requires_grad_(True) for p in flat]
            loss, _ = model.loss_fn(tree_unflatten(treedef, leaves), batch)
            results.append((loss.detach(), torch.autograd.grad(loss, leaves)))
        finally:
            TLy.USE_PALLAS = True
    (kl, kg), (pl, pg) = results
    _close(kl, pl, "loss", tol=1e-5)
    for a, b in zip(kg, pg):  # f32 sums in another order, through 2 layers
        _close(a, b, "grad", tol=1e-3)


# ---------------------------------------------------------------------------
# the int8 wire (CUDA C++): quantize_plane and dequant_mix
# ---------------------------------------------------------------------------

from repro_torch.kernels import quantize as q_kernel  # noqa: E402
from repro_torch.kernels.ref import (dequant_mix_ref,  # noqa: E402
                                     quantize_plane_ref)


def _assert_same(name, got, want):
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if not torch.equal(got, want):
        diff = (got.float() - want.float()).abs()
        raise AssertionError(f"{name}: {int((diff != 0).sum())} elements "
                             f"differ from the plain version, max "
                             f"{diff.max().item()}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [None, 3])
@pytest.mark.parametrize("n", [1, 127, 129, 1029, 1 << 20])
def test_quantize_kernels_bit_identical(cuda_device, dtype, M, n):
    """Both kernels against the plain versions on the same CUDA tensors,
    bit for bit: q, scales, residual (also written over itself, and with no
    residual) and both dequant_mix variants (also with out=x); 1-D (M=1)
    and stacked buffers, an all-zero row."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    shape = (n,) if M is None else (M, n)
    x, r, u = ((torch.randn(shape, generator=gen, device=cuda_device) * sc)
               .to(dtype) for sc in (3.0, 0.01, 0.01))
    if n > 256:
        x[..., 128:256] = 0
        r[..., 128:256] = 0
    want = quantize_plane_ref(x, r)
    before = (q_kernel.quantize_launches, q_kernel.dequant_mix_launches)
    for name, g, w in zip(("q", "scales", "resid"),
                          ops.quantize_plane(x, r), want):
        _assert_same(name, g, w)
    for name, g, w in zip(("q", "scales", "resid"), ops.quantize_plane(x),
                          quantize_plane_ref(x)):
        _assert_same(f"{name} (no residual)", g, w)
    r_in = r.clone()
    got = ops.quantize_plane(x, r_in, out_resid=r_in)
    assert got[2] is r_in
    for name, g, w in zip(("q", "scales", "resid"), got, want):
        _assert_same(f"{name} (in place)", g, w)
    q, s = got[0], got[1]
    if M is None:
        a, b = torch.tensor(0.6, device=cuda_device), \
            torch.tensor(0.4, device=cuda_device)
    else:
        q, s = torch.roll(q, 1, 0), torch.roll(s, 1, 0)
        a = torch.rand(M, generator=gen, device=cuda_device)
        b = 1.0 - a
    for upd in (u, None):
        _assert_same(f"dequant_mix upd={upd is not None}",
                     ops.dequant_mix(x, q, s, upd, a, b),
                     dequant_mix_ref(x, q, s, upd, a, b))
    o = x.clone()
    assert ops.dequant_mix(o, q, s, u, a, b, out=o) is o
    _assert_same("dequant_mix out=x", o, dequant_mix_ref(x, q, s, u, a, b))
    torch.cuda.synchronize()
    assert (q_kernel.quantize_launches, q_kernel.dequant_mix_launches) == \
        (before[0] + 3, before[1] + 3)


@pytest.mark.gpu
def test_quantize_kernels_past_int32_offsets(cuda_device):
    """A stacked bf16 buffer of more than 2^31 elements (M=3, n % 128 != 0,
    about 11 GB of operands): the last worker's row, whose offsets pass
    2^31, and the first against the plain version on that row alone (the
    layout is per worker, so row m of a stacked call is the 1-D call on
    row m)."""
    M, n = 3, 715_827_883  # M·n = 2^31 + 1
    gen = torch.Generator(device=cuda_device).manual_seed(31)
    x = torch.randn((M, n), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    r = torch.randn((M, n), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16) * 0.01
    r_rows = {m: r[m].clone() for m in (0, M - 1)}  # r is overwritten
    q, s, _ = ops.quantize_plane(x, r, out_resid=r)
    a = torch.tensor([0.5, 0.6, 0.7], device=cuda_device)
    b = 1.0 - a
    q_recv, s_recv = torch.roll(q, 1, 0), torch.roll(s, 1, 0)
    o = ops.dequant_mix(x, q_recv, s_recv, None, a, b)
    torch.cuda.synchronize()
    for m, r_m in r_rows.items():
        want = quantize_plane_ref(x[m], r_m)
        for name, g, w in zip(("q", "scales", "resid"), (q[m], s[m], r[m]),
                              want):
            _assert_same(f"row {m} {name}", g, w)
        del want
        _assert_same(f"row {m} dequant_mix", o[m], dequant_mix_ref(
            x[m], q_recv[m], s_recv[m], None, a[m], b[m]))
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# rmsnorm and the SSD chunked scan (CUDA C++)
# ---------------------------------------------------------------------------

from repro_torch.kernels import rmsnorm as rms_kernel  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_kernel  # noqa: E402
from repro_torch.kernels.ref import (rmsnorm_ref, ssd_ref,  # noqa: E402
                                     ssd_scan_ref)


def _rms_close(got, want, name):
    """float32: rtol 1e-5, atol 1e-6 (the row's sum of squares runs in
    another order). bfloat16: within one bf16 ulp of each element
    (2^-7 × |want|): each side rounds a float32 result that close."""
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if got.dtype == torch.bfloat16:
        _close(got, want, name, tol=0.0, ulp=2.0 ** -7)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                                   msg=name)


# the JAX tests' shapes, the Mamba2 step's norms (pre-norm d 1536,
# gate_norm d_inner 3072), the decoder's 1024, d with a ragged tail, and
# rows shared by several warps (40960 bf16, 9000 f32) or too wide for
# registers (70001 f32 one element an access, 140000 bf16 vectors)
RMS_CASES = [((4, 64), torch.float32), ((2, 7, 128), torch.float32),
             ((300, 32), torch.float32), ((4, 64), torch.bfloat16),
             ((2, 7, 128), torch.bfloat16), ((300, 32), torch.bfloat16),
             ((2, 256, 1536), torch.bfloat16),
             ((2, 256, 3072), torch.bfloat16), ((1024, 1024), torch.float32),
             ((5, 33), torch.float32), ((3, 77), torch.bfloat16),
             ((1, 1), torch.float32), ((16384, 4096), torch.bfloat16),
             ((3, 40960), torch.bfloat16), ((2, 9000), torch.float32),
             ((2, 70001), torch.float32), ((2, 140000), torch.bfloat16)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", RMS_CASES, ids=str)
def test_rmsnorm_kernel_matches_plain_version(cuda_device, shape, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = (torch.randn(shape, generator=gen, device=cuda_device) * 3).to(dtype)
    g = (1 + 0.1 * torch.randn(shape[-1:], generator=gen,
                               device=cuda_device)).to(dtype)
    before = rms_kernel.launches
    got = ops.rmsnorm(x, g)
    torch.cuda.synchronize()
    assert rms_kernel.launches == before + 1
    _rms_close(got, rmsnorm_ref(x, g), f"rmsnorm {shape} {dtype}")
    # gamma in the other dtype (the model's gamma has the params' dtype)
    g2 = g.to(torch.float32 if dtype == torch.bfloat16 else torch.bfloat16)
    _rms_close(ops.rmsnorm(x, g2), rmsnorm_ref(x, g2), "mixed gamma")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [((512, 3072), torch.bfloat16),
                                         ((1024, 1024), torch.float32),
                                         ((3, 40960), torch.bfloat16)],
                         ids=str)
def test_rmsnorm_kernel_is_deterministic(cuda_device, shape, dtype):
    """Two calls on the same inputs give the same bits: the row's sum adds
    in a fixed order, across warps too."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    x = (torch.randn(shape, generator=gen, device=cuda_device) * 3).to(dtype)
    g = torch.rand(shape[-1:], generator=gen, device=cuda_device).to(dtype)
    assert torch.equal(ops.rmsnorm(x, g), ops.rmsnorm(x, g))


@pytest.mark.gpu
def test_rmsnorm_kernel_rejects_strided_input(cuda_device):
    x = torch.randn(8, 64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rmsnorm(x.t(), torch.ones(8, device=cuda_device))


def _ssd_operands(gen, B, H, S, P, N, dtype, dev, model_layout=False):
    """The JAX test's distributions. ``model_layout``: x as a (B,H,S,P)
    view of a (B,S,H,P) tensor, dt float32 as a view of (B,S,H), Bm and
    Cm column slices of one (B, S, 2N+1) tensor, as the model holds them."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    A = -torch.exp(randn(H) * 0.3)
    if model_layout:
        x = (randn(B, S, H, P) * 0.5).to(dtype).transpose(1, 2)
        dt = torch.nn.functional.softplus(randn(B, S, H)).transpose(1, 2)
        bc = (randn(B, S, 2 * N + 1) * 0.5).to(dtype)
        return x, dt, A, bc[..., 1:N + 1], bc[..., N + 1:]
    x = (randn(B, H, S, P) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(randn(B, H, S)).to(dtype)
    return (x, dt, A, (randn(B, S, N) * 0.5).to(dtype),
            (randn(B, S, N) * 0.5).to(dtype))


def _ssd_close(got, want, msg=""):
    """The JAX test's ``_tol``: |got − want| ≤ atol + rtol·|want|, bfloat16
    2e-2 / 2e-2, float32 rtol 2e-4 and atol 2e-5 × max(1, max |want|): the
    kernel and cuBLAS sum the chunk's products in other orders, so in
    float32 they differ by rounding of the summands, whose size grows with
    the output's (at the step's shape, up to 3e-5 where y is near 0)."""
    g, w = got.float(), want.float()
    if got.dtype == torch.bfloat16:
        rtol, atol = 2e-2, 2e-2
    else:
        rtol, atol = 2e-4, 2e-5 * max(1.0, w.abs().max().item())
    excess = ((g - w).abs() - atol - rtol * w.abs()).max().item()
    assert excess <= 0, f"{msg}: error exceeds {atol} + {rtol}|want| by " \
        f"{excess}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("B,H,S,P,N,chunk", [
    (1, 2, 32, 8, 4, 8), (2, 3, 64, 16, 8, 16), (1, 1, 64, 32, 16, 64),
    (2, 4, 256, 64, 128, 128), (1, 2, 2048, 64, 128, 128),
    (1, 2, 96, 40, 24, 24), (1, 2, 1280, 16, 8, 64)])
def test_ssd_scan_kernel_matches_plain_version(cuda_device, dtype, B, H, S,
                                               P, N, chunk):
    """The JAX test's cases, the step's chunk and state (S=2048: 16 chunks
    carry the state), P not a multiple of the 32-column tile, and 20
    chunks (the state pass loads 8 at a time)."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    args = _ssd_operands(gen, B, H, S, P, N, dtype, cuda_device)
    before = ssd_kernel.launches
    y = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_kernel.launches == before + 1
    assert y.shape == (B, H, S, P) and y.dtype == dtype
    for name, want in (("plain", ssd_scan_ref(*args, chunk=chunk)),
                       ("sequential", ssd_ref(*args))):
        _ssd_close(y, want, f"ssd_scan vs {name}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_ssd_scan_kernel_reads_model_views(cuda_device, dtype):
    """The Mamba2 step's shape from strided views, without copies."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    args = _ssd_operands(gen, 2, 48, 256, 64, 128, dtype, cuda_device,
                         model_layout=True)
    assert not args[0].is_contiguous() and not args[3].is_contiguous()
    y = ops.ssd_scan(*args)
    want = ssd_scan_ref(*(a.contiguous() for a in args))
    _ssd_close(y, want, "ssd_scan from the model's views")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_ssd_scan_kernel_is_deterministic(cuda_device, dtype):
    """Two calls on the same inputs give the same bits (no atomics), at
    the step's shape and at S=2048, whose states carry over 16 chunks."""
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    for S in (256, 2048):
        args = _ssd_operands(gen, 2, 48, S, 64, 128, dtype, cuda_device,
                             model_layout=True)
        assert torch.equal(ops.ssd_scan(*args), ops.ssd_scan(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_ssd_scan_kernel_reads_misaligned_views(cuda_device, dtype):
    """x at storage offset 1 with an odd sequence stride, and Bm, Cm
    sliced at offset 1 of one (B, S, 2N+1) tensor: none takes the 16-byte
    copies as it is; a kernel of the call packs all three into aligned
    rows first."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    B, H, S, P, N = 2, 4, 256, 40, 24
    x, dt, A, Bm, Cm = _ssd_operands(gen, B, H, S, P, N, dtype, cuda_device,
                                     model_layout=True)
    buf = torch.zeros(B * S * (H * P + 3) + 1, dtype=dtype,
                      device=cuda_device)
    xm = buf[1:].view(B, S, H * P + 3)[..., :H * P].view(
        B, S, H, P).transpose(1, 2)
    xm.copy_(x)
    assert not any(ssd_kernel.aligned(t) for t in (xm, Bm, Cm))
    cfg = ssd_kernel.launch_config(xm, Bm, Cm, chunk=64)
    assert cfg["ssd_pack_kernel"]["blocks"] == 3 * B * -(-H * S * P // 256)
    aligned_x = ssd_kernel.launch_config(x, Bm, Cm, chunk=64)
    assert aligned_x["ssd_pack_kernel"]["blocks"] == 2 * B * -(-S * N // 256)
    y = ops.ssd_scan(xm, dt, A, Bm, Cm, chunk=64)
    want = ssd_scan_ref(*(a.contiguous() for a in (x, dt, A, Bm, Cm)),
                        chunk=64)
    _ssd_close(y, want, "ssd_scan from misaligned views")


@pytest.mark.gpu
def test_ssd_scan_kernel_rejects_what_it_does_not_take(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    x, dt, A, Bm, Cm = _ssd_operands(gen, 1, 2, 64, 8, 4, torch.float32,
                                     cuda_device)
    with pytest.raises(ValueError, match="divide"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=24)
    big = torch.zeros(1, 64, 129, device=cuda_device)
    with pytest.raises(ValueError, match="state size"):
        ops.ssd_scan(x, dt, A, big, big)
    with pytest.raises(ValueError, match="dtype"):
        ops.ssd_scan(x, dt, A, Bm.to(torch.bfloat16), Cm.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the pipeline and stream engines on the card
# ---------------------------------------------------------------------------

ENGINE_STEPS = 4


def _decoder_run(engine_kw, *, steps=ENGINE_STEPS, wrap=None, **kw):
    """A 2-layer decoder at GPT-2 Medium's width (d 1024, vocab 50257), M=2,
    R=2, D=1, through the kernels: each step's metrics (host floats) and the
    final read plane. The stream engine's threads are closed on the way
    out."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.backend import make_backend
    from repro_torch.models import build_model
    from repro_torch.optim import constant, momentum

    cfg = get_config("gpt2-medium").with_(num_layers=2)
    model = build_model(cfg)
    loss_fn = model.loss_fn if wrap is None else wrap(model.loss_fn)
    be = make_backend("prod", "layup", M=2, loss_fn=loss_fn,
                      optimizer=momentum(0.9), schedule=constant(3e-3),
                      fb_ratio=2, update_delay=1, use_pallas=True,
                      device="cuda", wait_timeout_s=120.0, **engine_kw, **kw)
    rng = np.random.default_rng(0)
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 4, 129)))
            .cuda() for _ in range(steps)]
    try:
        st = be.init(None, model.init(seed=0, device="cuda"))
        hist = []
        for t in toks:
            st, m = be.step(st, {"tokens": t[..., :-1], "labels": t[..., 1:]})
            hist.append(m)
        hist = [{k: float(m[k]) for k in ("loss", "update_staleness",
                                          "weight_sum", "disagreement",
                                          "staleness_mean", "nonfinite_skips",
                                          "peers_live") if k in m}
                for m in hist]
        read = st["read"]
        if hasattr(be.engine, "materialize"):
            read = be.engine.materialize(read)
        read = {k: v.clone() for k, v in read.items()}
        torch.cuda.synchronize()
        return hist, read, be.summary()
    finally:
        if hasattr(be.engine, "close"):
            be.engine.close()


@pytest.fixture(scope="module")
def monolithic_runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return {wire: _decoder_run({}, **kw) for wire, kw in (
        ("param", {}), ("int8", dict(wire="int8", compensate=0.5)))}


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ["param", "int8"])
@pytest.mark.parametrize("engine_kw", [
    dict(overlap=True), dict(overlap=True, streams=2),
    dict(overlap=True, streams=3)], ids=["pipeline", "streams2", "streams3"])
def test_engines_bit_identical_to_monolithic_step(monolithic_runs, engine_kw,
                                                  wire):
    """Every metric of every step and the final read plane, bit for bit;
    with ``wire="int8"`` the int8 wire and λ=0.5. cuBLAS gives the same bits
    on every stream with ``CUBLAS_WORKSPACE_CONFIG`` set (module top)."""
    kw = dict(wire="int8", compensate=0.5) if wire == "int8" else {}
    want = monolithic_runs[wire]
    hist, read, summary = _decoder_run(engine_kw, **kw)
    assert hist == want[0]
    for k in want[1]:
        assert torch.equal(read[k], want[1][k]), k
    assert summary["streams"] == float(engine_kw.get("streams", 1))


@pytest.mark.gpu
def test_stream_mix_never_writes_a_plane_a_forward_reads(cuda_device):
    """24 steps on three streams: every forward slice checksums its
    parameters just before and just after its loss on the fwd stream (with
    a spin kernel between, to widen the window); the
    gossip stream's mixes write the other buffer of each group's ping-pong
    pair, so no checksum pair may differ. The forwards and the mixes also
    ran at the same time on the card (``exec_overlap_s`` > 0)."""
    from _torch_watch import PlaneWatch

    watch = {}

    def wrap(loss_fn):
        watch["w"] = PlaneWatch(loss_fn, hold=1e-3)  # ~1e6 cycles a slice
        return watch["w"]

    _, _, summary = _decoder_run(dict(overlap=True, streams=3), steps=24,
                                 wrap=wrap, measure_drift=False)
    assert len(watch["w"].pairs) == 24 * 2 * 2  # steps x workers x slices
    assert watch["w"].changed() == 0
    assert summary["exec_overlap_s"] > 0.0


# ---------------------------------------------------------------------------
# chaos injection and membership on the card
# ---------------------------------------------------------------------------

CHAOS = ("crash:peer=1,step=2,recover=6;nan:step=4,peer=0,group=0;"
         "corrupt:step=5,group=1")
CHAOS_COUNTERS = ("faults_injected", "rounds_degraded", "peers_dead",
                  "resyncs", "nan_injections", "rounds_sealed",
                  "checksum_rejects", "resends", "nonfinite_skips",
                  "peers_live", "time_to_detect_steps",
                  "time_to_resync_steps")


def _chaos_run(device, M, **kw):
    """A 2-layer decoder at GPT-2 Medium's width, M workers, R=2, D=1,
    sequences of 64, ``faults=CHAOS``, 8 steps on ``device``: each step's
    loss, Σw and ``peers_live``, and the summary."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.backend import make_backend
    from repro_torch.models import build_model
    from repro_torch.optim import constant, momentum

    cfg = get_config("gpt2-medium").with_(num_layers=2)
    model = build_model(cfg)
    be = make_backend("prod", "layup", M=M, loss_fn=model.loss_fn,
                      optimizer=momentum(0.9), schedule=constant(3e-3),
                      fb_ratio=2, update_delay=1, use_pallas=True,
                      device=device, wait_timeout_s=120.0, faults=CHAOS,
                      **kw)
    rng = np.random.default_rng(0)
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (M, 2, 65)))
            .to(device) for _ in range(8)]
    try:
        # the same weights on both devices: made on the CPU, copied by init
        st = be.init(None, model.init(seed=0, device="cpu"))
        hist = []
        for t in toks:
            st, m = be.step(st, {"tokens": t[..., :-1], "labels": t[..., 1:]})
            hist.append({k: float(m[k]) for k in ("loss", "weight_sum",
                                                  "peers_live")})
        return hist, be.summary()
    finally:
        if hasattr(be.engine, "close"):
            be.engine.close()


@pytest.mark.gpu
@pytest.mark.parametrize("M", [2, 4])
def test_chaos_run_on_card_as_on_cpu(cuda_device, M):
    """The same faulted run on CPU tensors (plain attention and mix) and on
    the card (the kernels): finite loss and Σw, the same membership
    history and controller counters, losses within 1e-3."""
    import numpy as np

    cpu_hist, cpu_sum = _chaos_run("cpu", M)
    gpu_hist, gpu_sum = _chaos_run("cuda", M)
    for h in gpu_hist:
        assert np.isfinite(h["loss"]) and abs(h["weight_sum"] - 1.0) < 1e-5
    assert [h["peers_live"] for h in gpu_hist] == \
        [h["peers_live"] for h in cpu_hist]
    assert {k: gpu_sum.get(k) for k in CHAOS_COUNTERS} == \
        {k: cpu_sum.get(k) for k in CHAOS_COUNTERS}
    assert gpu_sum["resyncs"] == 1 and gpu_sum["nonfinite_skips"] >= 1.0
    np.testing.assert_allclose([h["loss"] for h in gpu_hist],
                               [h["loss"] for h in cpu_hist], rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("engine_kw", [{}, dict(overlap=True, streams=3)],
                         ids=["monolithic", "streams3"])
def test_chaos_empty_plan_bit_identical_on_card(monolithic_runs, engine_kw):
    """``faults=""`` gives the fault-free step's bits on the card."""
    want = monolithic_runs["param"]
    hist, read, summary = _decoder_run(engine_kw, faults="")
    assert [{k: v for k, v in h.items() if k != "peers_live"}
            for h in hist] == want[0]
    assert all(h["peers_live"] == 2.0 for h in hist)
    for k in want[1]:
        assert torch.equal(read[k], want[1][k]), k
    assert summary["faults_injected"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ["param", "int8"])
def test_chaos_streams_match_monolithic_on_card(cuda_device, wire):
    """A faulted run on three streams gives the monolithic step's bits
    (crash, NaN, corrupt; M=2, 8 steps)."""
    kw = dict(faults=CHAOS, steps=8)
    if wire == "int8":
        kw["wire"] = "int8"
    want = _decoder_run({}, **kw)
    got = _decoder_run(dict(overlap=True, streams=3), **kw)
    assert got[0] == want[0]
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k
    assert got[2]["resyncs"] == want[2]["resyncs"] == 1


# ---------------------------------------------------------------------------
# serving on the card: the decode path, prefill, live swaps across streams
# ---------------------------------------------------------------------------

def _serve_model(name):
    """A 2-layer model at a cut width, with weights made on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    if name == "gpt2-medium":
        cfg = get_config(name).with_(num_layers=2, d_model=256, num_heads=4,
                                     num_kv_heads=4, d_ff=512,
                                     vocab_size=512)
    else:
        cfg = get_config(name).with_(num_layers=2, d_model=256,
                                     vocab_size=512, ssm_state=16,
                                     ssm_head_dim=32)
    model = build_model(cfg)
    return model, model.init(seed=0, device="cpu")


def _gap(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gpt2-medium", "mamba2-780m"])
def test_serve_decode_and_prefill_on_card_as_on_cpu(cuda_device, name):
    """prefill_fn (the flash forward on the card, the plain attention on
    the CPU) and 12 steps of decode_fn, the same weights on both devices:
    logits and caches within 1e-4 of their largest |value| in float32,
    2e-2 in bf16 (Mamba2). The prefill launches the flash forward once per
    layer and neither backward kernel."""
    from repro_torch.core.pytree import tree_map
    from repro_torch.models.transformer import alloc_cache

    model, cpu_params = _serve_model(name)
    gpu_params = tree_map(lambda x: x.to(cuda_device), cpu_params)
    tol = 2e-2 if model.cfg.dtype == torch.bfloat16 else 1e-4
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 12), generator=gen)
    fa_kernel.reset_launches()
    gc, gl = model.prefill_fn(gpu_params, {"tokens": toks.to(cuda_device)})
    torch.cuda.synchronize()
    attn = "k" in gc["sub0"]
    assert (fa_kernel.fwd_launches, fa_kernel.dq_launches,
            fa_kernel.dkv_launches) == ((2 if attn else 0), 0, 0)
    cc, cl = model.prefill_fn(cpu_params, {"tokens": toks})
    assert _gap(gl, cl) <= tol
    for k in cc["sub0"]:
        assert _gap(gc["sub0"][k], cc["sub0"][k]) <= tol, k
    caches = {d: alloc_cache(model.cache_specs(2, 16), device=d)
              for d in ("cpu", cuda_device)}
    params = {"cpu": cpu_params, cuda_device: gpu_params}
    for t in range(12):
        pos = torch.tensor([t, max(t - 2, 0)])
        out = {}
        for d in caches:
            out[d], caches[d] = model.decode_fn(
                params[d], caches[d], toks[:, t:t + 1].to(d), pos.to(d))
        assert _gap(out[cuda_device], out["cpu"]) <= tol, t
    for k in caches["cpu"]["sub0"]:
        assert _gap(caches[cuda_device]["sub0"][k],
                    caches["cpu"]["sub0"][k]) <= tol, k


@pytest.mark.gpu
def test_serve_prefill_kernel_route_matches_plain_route(cuda_device):
    """prefill_fn through the flash forward against USE_PALLAS=False (the
    plain attention) on the same CUDA tensors: logits and K/V to 1e-5 of
    their largest |value|."""
    from repro_torch.core.pytree import tree_map
    from repro_torch.models import layers

    model, params = _serve_model("gpt2-medium")
    params = tree_map(lambda x: x.to(cuda_device), params)
    toks = {"tokens": torch.randint(0, 512, (3, 77), device=cuda_device)}
    kc, kl = model.prefill_fn(params, toks)
    layers.USE_PALLAS = False
    try:
        pc, pl = model.prefill_fn(params, toks)
    finally:
        layers.USE_PALLAS = True
    assert _gap(kl, pl) <= 1e-5
    for k in ("k", "v"):
        assert _gap(kc["sub0"][k], pc["sub0"][k]) <= 1e-5


@pytest.mark.gpu
def test_serve_live_swap_across_streams(cuda_device):
    """The trainer and the server on two threads, each on a CUDA stream of
    its own: every snapshot the server swaps in is unpacked, bit for bit,
    into the params it serves (worker 0's row), over 20 swaps. The trainer
    starts a step once the server has polled every earlier snapshot, so
    none is skipped; the server's copy of a row runs on its stream while
    the trainer's next step runs on the other."""
    import threading
    import time

    import numpy as np
    from repro_torch.core.backend import make_backend
    from repro_torch.core.pytree import tree_leaves, tree_map
    from repro_torch.launch.serve import Request, ServeLoop
    from repro_torch.optim import constant, momentum
    from repro_torch.serving import LiveServer, PlanePublisher

    model, params = _serve_model("gpt2-medium")
    params = tree_map(lambda x: x.to(cuda_device), params)
    pub = PlanePublisher()
    be = make_backend("prod", "layup", M=2, loss_fn=model.loss_fn,
                      optimizer=momentum(0.9), schedule=constant(3e-3),
                      fb_ratio=2, update_delay=1, use_pallas=True,
                      device=cuda_device, publisher=pub)
    st = be.init(None, params)
    loop = ServeLoop(model, params, num_slots=2, max_len=64,
                     device=cuda_device)
    srv = LiveServer(loop, be.part, pub)
    snaps, errors, steps = {}, [], 21
    publish = pub.publish

    def keep(*a, **kw):
        snap = publish(*a, **kw)
        snaps[snap.seq] = snap
        return snap

    pub.publish = keep
    rng = np.random.default_rng(0)
    toks = [torch.from_numpy(rng.integers(0, 512, (2, 2, 33)))
            for _ in range(steps)]
    train_stream, serve_stream = torch.cuda.Stream(), torch.cuda.Stream()
    done = threading.Event()
    torch.cuda.synchronize()  # init's work, on the default stream

    def train():
        nonlocal st
        try:
            with torch.cuda.stream(train_stream):
                for t in range(steps):
                    # the server has polled every earlier snapshot
                    while len(srv.decisions) < t and not errors:
                        time.sleep(1e-4)
                    b = {k: v.to(cuda_device) for k, v in
                         (("tokens", toks[t][..., :-1]),
                          ("labels", toks[t][..., 1:]))}
                    st, _ = be.step(st, b)
        except Exception as e:  # reported by the test thread
            errors.append(e)
        finally:
            done.set()

    def serve():
        checked = 0
        try:
            with torch.cuda.stream(serve_stream):
                uid = 0
                while not (done.is_set() and srv.poll() is None
                           and srv.swap_count == checked):
                    if all(s.req is None for s in loop.slots):
                        loop.submit(Request(uid=uid,
                                            prompt=np.asarray([1, 2, 3]),
                                            max_new_tokens=4))
                        uid += 1
                    srv.step()
                    if srv.swap_count > checked:
                        seq, _ = loop.params_version
                        while seq not in snaps:  # set just after publish
                            time.sleep(1e-4)
                        snap = snaps[seq]
                        want = be.part.unpack(
                            {g: b[0] for g, b in snap.plane.items()})
                        for a, w in zip(tree_leaves(loop.params),
                                        tree_leaves(want)):
                            if not torch.equal(a, w):
                                raise AssertionError(f"swap {seq} differs")
                        checked = srv.swap_count
                    if errors:
                        return
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=f) for f in (train, serve)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not errors, errors
    assert srv.swap_count >= 20
    assert pub.stats.copied_planes == pub.stats.published == steps
