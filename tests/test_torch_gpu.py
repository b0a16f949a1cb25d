"""Tests of the port that need a CUDA card (marker ``gpu``); they skip
without one. This file imports neither jax nor the JAX package, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import pytest

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
