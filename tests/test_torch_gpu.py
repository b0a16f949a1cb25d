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

# (B, Hq, Hkv, S, D, causal, window, dtype), S one length or (Sq, Sk): the
# training step's shape, GQA, MQA, windows, bidirectional, D=32/128, S not a
# multiple of the tile; the bf16 families' step shapes at B=1 (the dk/dv
# split past 1 at Jamba's, Qwen2-VL's and the MoE's few KV heads)
FLASH_CASES = [
    (2, 16, 16, 256, 64, True, 0, torch.float32),
    (1, 8, 2, 200, 64, True, 0, torch.float32),
    (1, 8, 1, 130, 32, True, 48, torch.float32),
    (2, 4, 4, 96, 128, False, 0, torch.float32),
    (1, 4, 2, 77, 64, False, 20, torch.float32),
    (2, 8, 2, 256, 64, True, 0, torch.bfloat16),
    (1, 4, 4, 100, 128, True, 32, torch.bfloat16),
    (2, 32, 4, 256, 128, True, 0, torch.bfloat16),  # the MoE step's (qwen3)
    (1, 20, 20, (256, 1500), 64, False, 0, torch.bfloat16),  # whisper cross
    (1, 20, 20, 1500, 64, False, 0, torch.bfloat16),  # whisper encoder
    (1, 20, 20, 256, 64, True, 0, torch.bfloat16),    # whisper decoder
    (1, 32, 8, 256, 128, True, 0, torch.bfloat16),    # jamba
    (1, 12, 2, 256, 128, True, 0, torch.bfloat16),    # qwen2-vl
]


def _lens(S):
    """(Sq, Sk) of a case's S: one length, or the pair."""
    return tuple(S) if isinstance(S, tuple) else (S, S)


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
    Sq, Sk = _lens(S)
    gen = torch.Generator(device=cuda_device).manual_seed(
        Sq + D + (Sk if Sk != Sq else 0))
    q = _decoder_layout(gen, B, Hq, Sq, D, dtype, cuda_device)
    k, v = (_decoder_layout(gen, B, Hkv, Sk, D, dtype, cuda_device)
            for _ in range(2))
    do = _decoder_layout(gen, B, Hq, Sq, D, dtype, cuda_device)
    kw = dict(causal=causal, window=window)
    before = (fa_kernel.fwd_launches, fa_kernel.dq_launches,
              fa_kernel.dkv_launches)
    sums = fa_kernel.dkv_sum_launches
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
    split = fa_kernel.dkv_split(B, Hq, Hkv, Sq, Sk, dtype,
                                fa_kernel.sm_count(cuda_device))
    assert fa_kernel.dkv_sum_launches == sums + (split > 1)


@pytest.mark.gpu
def test_flash_f32_main_shape_keeps_its_margin(cuda_device):
    """The f32 kernels at the training step's shape (B=2, H=16, S=256,
    D=64, causal), on chip_smoke.py's own first flash inputs (generator
    4321, (B, S, H, D) tensors): the error of each output as a share of
    its gate stays within the margin the f32 kernels kept before the bf16
    redesign (NVIDIA H100 80GB HBM3: o 0.114, lse 0.022, dq 0.020, dk
    0.037, dv 0.025)."""
    B, H, S, D = 2, 16, 256, 64
    gen = torch.Generator(device=cuda_device).manual_seed(4321)
    q, k, v, do = (_decoder_layout(gen, B, H, S, D, torch.float32,
                                   cuda_device) for _ in range(4))
    got, want = _flash_pair(q, k, v, do, dict(causal=True))
    margin = {"o": 0.12, "lse": 0.03, "dq": 0.03, "dk": 0.05, "dv": 0.03}
    for n, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        tol = 1e-4 if n.startswith("d") else 1e-5
        share = ((g - w).abs().max() / (tol * w.abs().max())).item()
        assert share <= margin[n], (n, share)


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
@pytest.mark.parametrize("case", [FLASH_CASES[0], FLASH_CASES[5],
                                  (2, 12, 2, 256, 128, True, 0,
                                   torch.bfloat16)], ids=str)
def test_flash_kernels_are_deterministic(cuda_device, case):
    """Two calls on the same inputs give bit-identical o, lse, dq, dk and
    dv: the backward sums in a fixed order, with no atomics; the last case
    (Qwen2-VL's step shape, 2 KV heads) through the dk/dv split and its
    summing kernel."""
    B, Hq, Hkv, S, D, causal, window, dtype = case
    if Hkv == 2:
        assert fa_kernel.dkv_split(B, Hq, Hkv, S, S, dtype,
                                   fa_kernel.sm_count(cuda_device)) > 1
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


# (B, Hq, Hkv, Sq, Sk, D, causal, dtype): query and key lengths that differ
# (the encoder-decoder's cross-attention, Sq > Sk and Sq < Sk at odd
# sizes) and the encoder-decoder's, hybrid's and VLM's step shapes
FLASH_PAIRS = [
    (2, 20, 20, 256, 1500, 64, False, torch.bfloat16),   # whisper cross
    (2, 20, 20, 1500, 1500, 64, False, torch.bfloat16),  # whisper encoder
    (1, 4, 2, 333, 129, 64, True, torch.float32),        # Sq > Sk
    (1, 6, 3, 97, 301, 32, False, torch.float32),        # Sq < Sk
    (2, 32, 8, 256, 256, 128, True, torch.bfloat16),     # jamba
    (2, 12, 2, 256, 256, 128, True, torch.bfloat16),     # qwen2-vl
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_PAIRS, ids=str)
def test_flash_kernels_at_query_and_key_lengths(cuda_device, case):
    """Forward and backward against the plain versions with q of Sq rows
    and k, v of Sk (a causal query row q sees keys 0..q; past Sk it sees
    them all), and two calls on the same inputs bit-identical."""
    B, Hq, Hkv, Sq, Sk, D, causal, dtype = case
    gen = torch.Generator(device=cuda_device).manual_seed(Sq + Sk)
    q, do = (_decoder_layout(gen, B, Hq, Sq, D, dtype, cuda_device)
             for _ in range(2))
    k, v = (_decoder_layout(gen, B, Hkv, Sk, D, dtype, cuda_device)
            for _ in range(2))
    kw = dict(causal=causal)
    got, want = _flash_pair(q, k, v, do, kw)
    for n, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, n
        if n == "lse":
            _close(g, w, n, tol=1e-5)
        else:
            _close(g, w, n, **_flash_tol(dtype, n.startswith("d")))
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


# ---------------------------------------------------------------------------
# the sim trainer, the tuner's clock and checkpoints on the card
# ---------------------------------------------------------------------------

SIM_ALGOS = ("layup", "layup-block", "layup-hypercube", "gosgd", "adpsgd",
             "ddp", "localsgd", "slowmo", "co2")


def _sim_run(device, algo, monkeypatch, steps=3):
    """Three sim steps of ``algo`` on a 2-layer cut GPT-2 decoder (M=4,
    R=2, D=1; flash on the card, plain attention on the CPU), the random
    draws made on the host from a seeded generator for both devices.
    Returns per-step metrics and the final plane on the host."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.convert import to_torch
    from repro_torch.core import adpsgd, api
    from repro_torch.core.api import get_algorithm
    from repro_torch.core.backend import make_backend
    from repro_torch.models import build_model
    from repro_torch.optim import constant, momentum

    host = torch.Generator().manual_seed(11)
    monkeypatch.setattr(api, "draw_peers", lambda rng, M, dev: torch.randint(
        0, M - 1, (M,), generator=host).to(dev))
    monkeypatch.setattr(adpsgd, "draw_permutation",
                        lambda rng, M, dev: torch.randperm(
                            M, generator=host).to(dev))
    cfg = get_config("gpt2-medium").with_(num_layers=2, d_model=128,
                                          num_heads=2, num_kv_heads=2,
                                          d_ff=256, vocab_size=256)
    model = build_model(cfg)
    # made on the CPU for both runs: a CUDA generator draws other numbers
    params = to_torch(model.init(seed=0, device="cpu"), device)
    kw = {"sync_every": 2} if algo in ("localsgd", "slowmo", "co2") else {}
    be = make_backend("sim", get_algorithm(algo, **kw), M=4,
                      loss_fn=model.loss_fn, optimizer=momentum(0.9),
                      schedule=constant(3e-3), fb_ratio=2, update_delay=1,
                      device=device)
    st = be.init(0, params)
    rng = np.random.default_rng(3)
    hist = []
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (4, 4, 65))
        st, m = be.step(st, {"tokens": toks[..., :-1],
                             "labels": toks[..., 1:]})
        hist.append({k: float(m[k]) for k in ("loss", "weight_sum",
                                               "update_staleness",
                                               "disagreement")})
        hist[-1]["mass"] = hist[-1]["weight_sum"] + in_flight(st.extras)
    return hist, {k: v.cpu() for k, v in st.params.items()}


def in_flight(extras) -> float:
    """The push-sum mass a block-mode queue holds (0 for the others)."""
    if isinstance(extras, dict) and "q0" in extras:
        return float(extras["q0"]["w"].sum() + extras["q1"]["w"].sum())
    return 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("algo", SIM_ALGOS)
def test_sim_step_on_card_as_on_cpu(cuda_device, monkeypatch, algo):
    """The same sim run on the card (flash kernels) and on the CPU (plain
    attention), the same draws: losses and metrics within 1e-3, planes
    within 1e-3 of their largest |value|, Σw = 1 (with the block modes'
    mass in flight); flash launched on the
    card (a step: 2 slices x 4 workers x 2 layers forward, plus the
    backward slice's recompute of its blocks, 4 x 2, and 4 x 2
    backward)."""
    import numpy as np

    fa_kernel.reset_launches()
    gpu_hist, gpu_plane = _sim_run("cuda", algo, monkeypatch)
    torch.cuda.synchronize()
    assert fa_kernel.fwd_launches == 3 * (2 + 1) * 4 * 2
    assert fa_kernel.dq_launches == fa_kernel.dkv_launches == 3 * 4 * 2
    cpu_hist, cpu_plane = _sim_run("cpu", algo, monkeypatch)
    for g, c in zip(gpu_hist, cpu_hist):
        assert abs(g["mass"] - 1.0) < 1e-5
        assert g["weight_sum"] == pytest.approx(c["weight_sum"], abs=1e-6)
        assert g["update_staleness"] == c["update_staleness"]
        np.testing.assert_allclose(g["loss"], c["loss"], rtol=1e-3)
        np.testing.assert_allclose(g["disagreement"], c["disagreement"],
                                   rtol=1e-3, atol=1e-6)
    for k in cpu_plane:
        scale = float(cpu_plane[k].abs().max())
        torch.testing.assert_close(gpu_plane[k], cpu_plane[k], rtol=0,
                                   atol=1e-3 * scale)


@pytest.mark.gpu
def test_tune_cuda_event_clock_against_scripted_duration(cuda_device):
    """The tuner's default clock on the card reads CUDA events: between two
    readings with a scripted 50 ms host pause (the stream idle) it reads
    50 ms; a harness whose runner pauses 20 ms reports 20 ms a rep."""
    import time

    from repro_torch.launch import tuner

    clock = tuner.default_clock(cuda_device)
    assert isinstance(clock, tuner.CudaEventClock)
    t0 = clock()
    time.sleep(0.05)
    dt = clock() - t0
    assert 0.05 <= dt < 0.07, dt
    cut = tuner.StageCutout("pause", None, (((4,), torch.float32),),
                            cuda_device)
    h = tuner.CutoutHarness(runner=lambda fn, args: time.sleep(0.02),
                            warmup=0, reps=3)
    t = h.time_cutout(cut)
    assert 0.02 <= t["best_s"] <= t["mean_s"] < 0.03, t


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_checkpoint_round_trip_of_cuda_tensors(cuda_device, dtype, tmp_path):
    """CUDA tensors of either dtype save and restore bit for bit, onto the
    device and dtype of ``like``."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    tree = {"plane": {"a": torch.randn((4, 1000), generator=gen,
                                       device=cuda_device).to(dtype),
                      "b": torch.randn((4, 7), generator=gen,
                                       device=cuda_device).to(dtype)},
            "w": torch.full((4,), 0.25, device=cuda_device),
            "fifo": [torch.zeros(3, device=cuda_device, dtype=dtype)]}
    save_checkpoint(str(tmp_path), 9, tree)
    like = {"plane": {k: torch.zeros_like(v)
                      for k, v in tree["plane"].items()},
            "w": torch.zeros(4, device=cuda_device),
            "fifo": [torch.ones(3, device=cuda_device, dtype=dtype)]}
    got = restore_checkpoint(str(tmp_path), None, like)
    for k, v in tree["plane"].items():
        assert got["plane"][k].device == v.device
        assert got["plane"][k].dtype == dtype
        assert torch.equal(got["plane"][k], v)
    assert torch.equal(got["w"], tree["w"])
    assert torch.equal(got["fifo"][0], tree["fifo"][0])


# ---------------------------------------------------------------------------
# the mixture-of-experts family on the card
# ---------------------------------------------------------------------------


def _moe_inputs(cfg, T, seed):
    """MoE parameters and (1, T, d) inputs drawn on the CPU, at ``cfg``'s
    dtype."""
    from repro_torch.models import moe as MoE
    from repro_torch.models.layers import init_params

    p = init_params(MoE.moe_specs(cfg), seed=seed, dtype=cfg.dtype,
                    device="cpu")
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((1, T, cfg.d_model), generator=gen).to(cfg.dtype)
    return p, x


@pytest.mark.gpu
def test_moe_apply_bit_identical_on_card(cuda_device):
    """``moe_apply`` forward and backward twice at the training step's
    shape (Qwen3-30B-A3B's width: T=512 tokens, 128 experts top-8, d 2048,
    expert d_ff 768, bf16; capacity 40 an expert): y, aux and the grads of
    router, experts and x identical bit for bit (no floating-point atomics
    in dispatch or combine), with no host synchronisation inside; some
    assignments drop."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MoE

    cfg = get_config("qwen3-moe-30b-a3b").with_(num_layers=1)
    p, x = _moe_inputs(cfg, 512, seed=0)
    names = ("router", "wi_gate", "wi_up", "wo")
    outs = []
    for _ in range(2):
        gp = {k: v.to(cuda_device).requires_grad_(True) for k, v in p.items()}
        gx = x.to(cuda_device).requires_grad_(True)
        torch.cuda.synchronize()
        # no host synchronisation on the step's path (no .item(), mask
        # indexing or nonzero): the debug mode raises on one
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = MoE.moe_apply(gp, gx, cfg)
            grads = torch.autograd.grad((y.float() ** 2).sum() + aux,
                                        [gp[k] for k in names] + [gx])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        outs.append((y, aux) + grads)
    torch.cuda.synchronize()
    for name, a, b in zip(("y", "aux") + names + ("x",), *outs):
        assert torch.equal(a, b), name
    C = MoE.capacity(512, 128, 8, cfg.capacity_factor)
    _, meta, _ = MoE._dispatch_group(x[0].to(cuda_device),
                                     {k: v.to(cuda_device)
                                      for k, v in p.items()}, cfg, C)
    assert C == 40 and not bool(meta.keep.all())


@pytest.mark.gpu
def test_moe_model_on_card_as_on_cpu(cuda_device):
    """reduced(qwen3-moe-30b-a3b) (qk_norm, top-2 of 4) at float32, the
    same weights on both devices: the routing equal, the loss, ce and aux
    within 1e-5 and every grad within 1e-4 of its largest |value| (the
    card's attention is the flash kernels)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.pytree import tree_leaves, tree_map
    from repro_torch.models import build_model

    model = build_model(reduced(get_config("qwen3-moe-30b-a3b")))
    cpu_params = model.init(seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 33), generator=gen)
    out = {}
    for dev in ("cpu", cuda_device):
        params = tree_map(lambda t: t.to(dev).requires_grad_(True),
                          cpu_params)
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        loss, metrics = model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        out[dev] = (loss, metrics, grads)
    (cl, cm, cg), (gl, gm, gg) = out["cpu"], out[cuda_device]
    for a, b in ((gl, cl), (gm["ce"], cm["ce"]), (gm["aux"], cm["aux"])):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-5,
                                   atol=0)
    for a, b in zip(gg, cg):
        assert _gap(a, b) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "qwen2-vl-2b",
                                  "whisper-large-v3"])
def test_family_model_on_card_as_on_cpu(cuda_device, name):
    """The reduced hybrid, VLM and encoder-decoder models in float32, the
    same weights and ``lm_batch_for`` batch on both devices (jamba at
    ``capacity_factor=8``, where nothing drops): the loss within 1e-5 and
    every grad within 1e-4 of its largest |value| (the card's attention,
    cross-attention included, is the flash kernels)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.pytree import tree_leaves, tree_map
    from repro_torch.data.synthetic import lm_batch_for
    from repro_torch.models import build_model

    cfg = reduced(get_config(name)).with_(capacity_factor=8.0)
    model = build_model(cfg)
    cpu_params = model.init(seed=0, device="cpu")
    batch = lm_batch_for(cfg, 2, 32, generator=torch.Generator().manual_seed(1),
                         device="cpu")
    out = {}
    for dev in ("cpu", cuda_device):
        params = tree_map(lambda t: t.to(dev).requires_grad_(True),
                          cpu_params)
        loss, _ = model.loss_fn(params, {k: v.to(dev)
                                         for k, v in batch.items()})
        out[dev] = (loss, torch.autograd.grad(loss, tree_leaves(params)))
    (cl, cg), (gl, gg) = out["cpu"], out[cuda_device]
    torch.testing.assert_close(gl.detach().cpu(), cl.detach(), rtol=1e-5,
                               atol=0)
    for a, b in zip(gg, cg):
        assert (_gap(a, b) <= 1e-4 if bool(b.abs().max() > 0)
                else not bool(a.abs().max() > 0))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gpt2-medium", "qwen3-moe-30b-a3b"])
def test_remat_bit_identical_and_lower_peak_on_card(cuda_device, name):
    """Per-block activation checkpointing on the card: a small dense model
    and a small MoE (reduced widths, 8 layers, 8 x 256 tokens), the loss
    and every gradient of ``loss_fn`` with remat and with
    ``transformer.remat_block`` patched to the identity: bit for bit (the
    recompute repeats the flash forward and the MoE's stable routing), and
    the peak over the start lower with remat."""
    from unittest import mock

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.pytree import tree_flatten, tree_unflatten
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T

    cfg = reduced(get_config(name)).with_(num_layers=8)
    model = build_model(cfg)
    params = model.init(seed=0, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (8, 257), generator=gen,
                         device=cuda_device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def run():
        leaves, treedef = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = model.loss_fn(tree_unflatten(treedef, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.cuda.synchronize()
        return [loss] + list(grads), torch.cuda.max_memory_allocated() - base

    got, peak = run()
    with mock.patch.object(T, "remat_block", lambda f: f):
        want, peak_unwrapped = run()
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(got, want))
    print(f"{name}: peak over start {peak} B with remat, "
          f"{peak_unwrapped} B unwrapped")
    assert peak < peak_unwrapped


# ---------------------------------------------------------------------------
# the Model-level step factories (make_step) on the card
# ---------------------------------------------------------------------------


def _model_path_setup(M, steps=3):
    """A 2-layer decoder at GPT-2 Medium's width on the card (seed-0
    weights) and ``steps`` global batches of M·4 sequences of 128."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("gpt2-medium").with_(num_layers=2)
    model = build_model(cfg)
    rng = np.random.default_rng(0)
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                          (M * 4, 129))).cuda()
            for _ in range(steps)]
    batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]
    return model, model.init(seed=0, device="cuda"), batches


def _model_step(model, M, **kw):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import WorkerMesh
    from repro_torch.launch.train import make_step
    from repro_torch.optim import constant, momentum

    return make_step(model, WorkerMesh(M, "cuda"),
                     ShapeConfig("t", 128, M * 4, "train"),
                     optimizer=momentum(0.9), schedule=constant(3e-3), **kw)


def _stacked(params, M):
    from repro_torch.core.pytree import tree_map
    return tree_map(lambda x: x[None].expand((M,) + tuple(x.shape)), params)


@pytest.mark.gpu
def test_lockstep_pure_mix_kernel_against_plain(cuda_device):
    """The lockstep step with ``use_pallas``: the pure ``gossip_mix``
    kernel once per layer group per step, its losses and parameters within
    1e-6 of the largest |value| of the same steps through the plain
    ``gossip_plane_lane``."""
    from repro_torch.core.pytree import tree_leaves

    M = 2
    model, params, batches = _model_path_setup(M)
    runs = {}
    for pallas in (True, False):
        step = _model_step(model, M, use_pallas=pallas)
        p, o, w = step.init_state(_stacked(params, M))
        gm_kernel.reset_launches()
        losses = []
        for t, b in enumerate(batches):
            p, o, w, loss = step.fn(p, o, w, b, t, 0)
            losses.append(float(loss))
        runs[pallas] = (losses, tree_leaves(p), gm_kernel.launches)
    (kl, kp, kn), (pl, pp, pn) = runs[True], runs[False]
    assert kn == 3 * len(batches) and pn == 0  # 3 groups a step
    for a, b in zip(kl, pl):
        assert abs(a - b) <= 1e-6 * abs(b)
    for a, b in zip(kp, pp):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


@pytest.mark.gpu
def test_model_path_decoupled_bit_exact_vs_backend(cuda_device):
    """``make_step``'s decoupled step on the global batch against
    ``make_backend("prod")`` on the same worker rows, R=2, D=1, the fused
    kernel route: every metric and the read plane, bit for bit."""
    from repro_torch.core.backend import make_backend
    from repro_torch.optim import constant, momentum

    M = 2
    model, params, batches = _model_path_setup(M)
    kw = dict(fb_ratio=2, update_delay=1, use_pallas=True)
    be = make_backend("prod", "layup", M=M, loss_fn=model.loss_fn,
                      optimizer=momentum(0.9), schedule=constant(3e-3),
                      device="cuda", measure_drift=False, **kw)
    bst = be.init(None, params)
    step = _model_step(model, M, **kw)
    st = step.init_state(_stacked(params, M))
    for t, b in enumerate(batches):
        sim = {k: v.reshape((M, 4) + tuple(v.shape[1:]))
               for k, v in b.items()}
        bst, bm = be.step(bst, sim)
        st, m = step.fn(st, b, t, 0)  # M=2: one shift, index 0
        for k in ("loss", "update_staleness", "layer_staleness",
                  "weight_sum", "staleness_mean"):
            assert torch.equal(m[k], bm[k]), (k, t)
    for k, v in bst["read"].items():
        assert torch.equal(st["read"][k], v), k


# ---------------------------------------------------------------------------
# the multi-process worker ring (WorkerMesh with a process group)
# ---------------------------------------------------------------------------


def _cuda_hops_equal_roll(ranks):
    import _torch_ring_worker as W

    for res in ranks:
        got = res[("cuda_hops",)]
        for Mh in (4, 8):
            for dt in W.HOP_DTYPES:
                rows, hops = got[(Mh, dt)]
                full = W.hop_full(Mh, dt)
                for s, g in zip(range(1, Mh), hops):
                    want = torch.roll(full, s, 0)[rows[0]:rows[-1] + 1]
                    assert torch.equal(g, want), (Mh, dt, s, rows)
    return [res[("cuda_hops",)] for res in ranks]


@pytest.mark.gpu
def test_ring_hop_two_gloo_ranks_share_the_card(cuda_device, tmp_path):
    """Two gloo ranks on ``cuda:0``: ``ring_hop`` of CUDA tensors, staged
    through pinned host buffers, equals ``torch.roll`` bit for bit
    (float32, bfloat16, int8; M 4 and 8, every shift)."""
    import _torch_ring_worker as W

    ranks, _ = W.spawn(2, str(tmp_path), [("cuda_hops",)])
    for got in _cuda_hops_equal_roll(ranks):
        assert got["transport"] == "gloo+pinned-host-staging"
        assert got["staging_s"] > 0.0


@pytest.mark.gpu
def test_ring_hop_over_nccl(cuda_device, tmp_path):
    """Two nccl ranks, one card each: device tensors go straight to NCCL,
    no staging. Needs two cards."""
    import _torch_ring_worker as W

    if torch.cuda.device_count() < 2:
        pytest.skip("an nccl ring needs two cards")
    ranks, _ = W.spawn(2, str(tmp_path), [("cuda_hops",)], backend="nccl")
    for got in _cuda_hops_equal_roll(ranks):
        assert got["transport"] == "nccl" and got["staging_s"] == 0.0


def _ring_engine_equals_stacked(ranks, name):
    import _torch_ring_worker as W

    want = W.run_option(name, None, "cuda:0")
    job = ("cuda_option", name)
    for g, v in want["read"].items():
        got = torch.cat([r[job]["read"][g] for r in ranks])
        assert torch.equal(got, v), (name, g)
    for r in ranks:
        assert torch.equal(r[job]["w"], want["w"])
        assert torch.equal(r[job]["versions"], want["versions"])
        for k in ("loss", "weight_sum", "nonfinite_skips"):
            assert (r[job]["history"][k] == want["history"][k]).all(), k
    return [r[job] for r in ranks]


@pytest.mark.gpu
def test_ring_stream_engine_two_gloo_ranks_share_the_card(cuda_device,
                                                          tmp_path):
    """The stream engine (``streams=3``, int8 wire; ``streams=2``, param
    wire) over two gloo ranks on ``cuda:0``: its threads' hops, loss
    gathers and skip sums on groups of their own, staged through pinned
    host buffers on the stages' CUDA streams; the read plane, ``w``,
    ``versions`` and the histories bit for bit against the stacked engine
    (MLP, M=4, R=2, D=1)."""
    import _torch_ring_worker as W

    names = ("streams3_int8", "streams2")
    ranks, _ = W.spawn(2, str(tmp_path), [("cuda_option", n) for n in names])
    for n in names:
        for got in _ring_engine_equals_stacked(ranks, n):
            assert got["summary"]["staging_s"] > 0.0


@pytest.mark.gpu
def test_ring_row_copy_of_staged_cuda_rows(cuda_device, tmp_path):
    """``copy_row_`` between two gloo ranks on ``cuda:0`` (every pair of
    rows, across ranks staged) and ``gather_rows_to`` rank 0, bit for
    bit."""
    import _torch_ring_worker as W

    ranks, _ = W.spawn(2, str(tmp_path), [("cuda_rows",)])
    full = W.hop_full(W.M, "float32")
    for rank, res in enumerate(ranks):
        got = res[("cuda_rows",)]
        assert got["transport"] == "gloo+pinned-host-staging"
        for (src, dst), rows in got["copies"].items():
            want = full.clone()
            want[dst] = full[src]
            assert torch.equal(rows, want[2 * rank:2 * rank + 2]), (src, dst)
        if rank == 0:
            assert torch.equal(got["gather"], full)
        else:
            assert got["gather"] is None
    assert ranks[0][("cuda_rows",)]["staging_s"] > 0.0


@pytest.mark.gpu
def test_ring_stream_engine_over_nccl(cuda_device, tmp_path):
    """The stream engine over two nccl ranks, one card each (each thread's
    collectives on a communicator of its own). Needs two cards."""
    import _torch_ring_worker as W

    if torch.cuda.device_count() < 2:
        pytest.skip("an nccl ring needs two cards")
    ranks, _ = W.spawn(2, str(tmp_path), [("cuda_option", "streams3_int8")],
                       backend="nccl")
    for got in _ring_engine_equals_stacked(ranks, "streams3_int8"):
        assert got["summary"]["staging_s"] == 0.0


@pytest.mark.gpu
def test_gloo_point_to_point_does_not_take_cuda_tensors(cuda_device,
                                                       tmp_path):
    """Why ``WorkerMesh`` stages a gloo group's CUDA tensors through
    pinned host buffers: handed a CUDA tensor directly, gloo's
    point-to-point ops do not deliver its bits (they raise, or the rank
    dies). Each rank runs in a process of its own, killed after 90 s."""
    import multiprocessing as mp

    import _torch_ring_worker as W

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.direct_gloo_cuda_p2p,
                         args=(r, 2, str(tmp_path / "store"), str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(90)
        if p.is_alive():
            p.kill()
            p.join()
    outcomes = []
    for r, p in enumerate(procs):
        f = tmp_path / f"probe{r}.txt"
        outcomes.append(f.read_text() if f.exists()
                        else f"died (exit code {p.exitcode})")
    print("gloo p2p of CUDA tensors:", outcomes)
    assert "delivered" not in outcomes, outcomes



# ---------------------------------------------------------------------------
# lane spans on the profiler's clock
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_lane_spans_share_the_profilers_clock(cuda_device):
    """One GPT-2-shaped step (2 layers at GPT-2 Medium's width, M=2, R=2,
    D=1, fused) under the CUDA-only profiler: at least 99% of the trace's
    kernel launch calls lie inside the ``step`` span on the shared clock,
    and the lanes' device times (``fwd``, ``bwd``, ``pack``, ``update``,
    ``gossip``, ``drift``) sum to between 98% of the device's busy time
    and the profiled window."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.backend import make_backend
    from repro_torch.launch.timeline import lane_spans
    from repro_torch.models import build_model
    from repro_torch.optim import constant, momentum

    cfg = get_config("gpt2-medium").with_(num_layers=2)
    model = build_model(cfg)
    be = make_backend("prod", "layup", M=2, loss_fn=model.loss_fn,
                      optimizer=momentum(0.9), schedule=constant(3e-3),
                      fb_ratio=2, update_delay=1, use_pallas=True,
                      device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 8, 513), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    st = be.init(None, model.init(seed=0, device="cuda"))
    for _ in range(2):  # every shape warm
        st, _ = be.step(st, batch)
    torch.cuda.synchronize()
    lane_spans()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _ = be.step(st, batch)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    spans = lane_spans()
    kernels, launches = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            kernels.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif "LaunchKernel" in e.name():
            launches.append(e.start_ns())
    (step,) = [s for s in spans if s["name"] == "step"]
    inside = sum(step["start_ns"] <= t <= step["end_ns"] for t in launches)
    assert launches and inside >= 0.99 * len(launches), (inside,
                                                         len(launches))
    busy, end = 0, None
    for a, b in sorted(kernels):
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    lanes = sum(s["device_ms"] for s in spans if s["name"] != "step")
    print(f"lanes {lanes:.3f} ms, busy {busy / 1e6:.3f} ms, window "
          f"{window_ms:.3f} ms, launches in the step {inside}/"
          f"{len(launches)}")
    assert 0.98 * busy / 1e6 <= lanes <= window_ms
