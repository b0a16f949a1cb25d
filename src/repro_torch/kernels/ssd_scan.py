"""The Mamba2 SSD chunked scan on Hopper: the wrapper over the CUDA C++
kernel of ``src/repro_torch/csrc/ssd_scan.cu``. That file's header says
which TPU kernel it replaces (``repro/kernels/ssd_scan.py``), what bounds
it on the card and what its design does about that.

Layouts are the JAX kernel's: x ``(B, H, S, P)``, dt ``(B, H, S)``, A
``(H,)``, Bm and Cm ``(B, S, N)`` (shared across heads) → y ``(B, H, S,
P)`` in x's dtype. x, Bm and Cm are float32 or bfloat16 (one dtype), dt
float32 or bfloat16, A is cast to float32. Every operand is read through
its strides, so the model's ``(B, S, H, P)`` x and ``(B, S, H)`` dt go in
as transposed views without a copy; the last axis of x, Bm and Cm must be
dense. ``chunk`` (at most 128, and cut to S) must divide S; N is at most
128.

The library is built by ``nvcc`` at the first call (``_build``) and the
kernel launches on the current CUDA stream without synchronising.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_CHUNK = 128
MAX_STATE = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (a plain counter; chip_smoke.py
# zeroes it before the main path and reads it after)
launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SIGNATURES = {
    # dtype, dt dtype, B, H, S, P, N, chunk; x + 3 strides, dt + 3 strides,
    # A, Bm + 2 strides, Cm + 2 strides, y + 3 strides, stream
    "ssd_scan": [_I, _I] + [_L] * 6 + [_P, _L, _L, _L] * 2 + [_P]
    + [_P, _L, _L] * 2 + [_P, _L, _L, _L, _P],
}


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    return _build.load("ssd_scan", SIGNATURES)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """Launch ``ssd_scan_kernel``: y as
    :func:`repro_torch.kernels.ref.ssd_scan_ref` computes it."""
    global launches
    if x.dim() != 4 or dt.shape != x.shape[:3] or Bm.dim() != 3 \
            or Cm.shape != Bm.shape \
            or tuple(Bm.shape[:2]) != (x.shape[0], x.shape[2]) \
            or A.shape != (x.shape[1],):
        raise ValueError(
            f"ssd_scan wants x (B,H,S,P), dt (B,H,S), A (H,), Bm/Cm "
            f"(B,S,N); got {tuple(x.shape)}, {tuple(dt.shape)}, "
            f"{tuple(A.shape)}, {tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, H, S, P = x.shape
    N = Bm.shape[-1]
    chunk = min(int(chunk), S)
    if S and (chunk < 1 or S % chunk or chunk > MAX_CHUNK):
        raise ValueError(f"chunk {chunk} must divide S={S} and be at most "
                         f"{MAX_CHUNK}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"state size N={N} not built; the kernel takes "
                         f"1..{MAX_STATE}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"ssd_scan needs CUDA tensors on one device; "
                             f"{name} is on {t.device}, x on {x.device}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name} dtype {t.dtype} not built; the kernel "
                             "takes float32 and bfloat16")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.dtype != x.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != x dtype {x.dtype}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"the last axis of {name} must be dense "
                             f"(stride 1); got strides {t.stride()}")
    y = torch.empty((B, H, S, P), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    A32 = A.to(torch.float32).contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().ssd_scan(
            _DTYPES[x.dtype], _DTYPES[dt.dtype], B, H, S, P, N, chunk,
            x.data_ptr(), *x.stride()[:3], dt.data_ptr(), *dt.stride(),
            A32.data_ptr(), Bm.data_ptr(), *Bm.stride()[:2], Cm.data_ptr(),
            *Cm.stride()[:2], y.data_ptr(), *y.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan: CUDA launch failed with cudaError_t "
                           f"{err}")
    launches += 1
    return y
