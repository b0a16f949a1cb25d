"""Fused RMSNorm on Hopper: the wrapper over the CUDA C++ kernel of
``src/repro_torch/csrc/rmsnorm.cu``. That file's header says which TPU
kernel it replaces (``repro/kernels/rmsnorm.py``), what bounds it on the
card and what its design does about that.

``x`` ``(..., d)`` must be contiguous; any number of rows and any ``d``
run without a padded copy. ``gamma`` is ``(d,)``. float32 or bfloat16, for
``x`` and ``gamma`` independently; the output has x's shape and dtype.

The library is built by ``nvcc`` at the first call (``_build``) and the
kernel launches on the current CUDA stream without synchronising.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (a plain counter; chip_smoke.py
# zeroes it before the main path and reads it after)
launches = 0
# the counters are bumped from the stream engine's threads too
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SIGNATURES = {
    # dtype, gamma dtype, rows, d, eps, x, gamma, out, vec, stream
    "rmsnorm": [_I, _I, _L, _L, ctypes.c_float, _P, _P, _P, _I, _P],
    # dtype, rows, d, vec, SMs; 7 int64 (out): CUDA kernels a call, blocks,
    # threads, dynamic shared memory, vectors a lane (0: the two-pass
    # kernel), warps a row, rows a block
    "rmsnorm_config": [_I, _L, _L, _I, _I, _P],
}
# the device type the kernel runs on (tests of the argument lists swap it)
_DEVICE = "cuda"


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    return _build.load("rmsnorm", SIGNATURES)


@contextlib.contextmanager
def _device_stream(device):
    """``device`` made current; yields its current CUDA stream's handle."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream().cuda_stream


def launch_config(x: torch.Tensor, gamma: torch.Tensor) -> dict:
    """How a call on these operands launches (``x`` on a CUDA card):
    ``{"kernels", "blocks", "threads", "smem_bytes", "vectors_a_lane",
    "warps_a_row", "rows_a_block"}``; ``vectors_a_lane`` 0 is the two-pass
    kernel of rows too wide for registers."""
    d = x.shape[-1]
    rows = x.numel() // d
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    out = (ctypes.c_int64 * 7)()
    err = _lib().rmsnorm_config(_DTYPES[x.dtype], rows, d,
                                int(_vec_ok(d, (x, gamma, x))), sms, out)
    if err != 0:
        raise RuntimeError(f"rmsnorm_config: cudaError_t {err}")
    return dict(zip(("kernels", "blocks", "threads", "smem_bytes",
                     "vectors_a_lane", "warps_a_row", "rows_a_block"), out))


def _vec_ok(d: int, tensors) -> bool:
    """16-byte accesses: x's 16 B hold ``16 / itemsize`` elements; every
    operand must start on that many of its own elements, and d be a
    multiple of them."""
    per = 16 // tensors[0].element_size()
    return d % per == 0 and all(
        t.data_ptr() % (per * t.element_size()) == 0 for t in tensors)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """Launch ``rmsnorm_kernel``: ``x·rsqrt(mean(x²)+eps)·γ`` per row as
    :func:`repro_torch.kernels.ref.rmsnorm_ref`."""
    global launches
    if x.dim() < 1 or gamma.shape != x.shape[-1:]:
        raise ValueError(f"rmsnorm wants x (..., d) and gamma (d,); got "
                         f"{tuple(x.shape)} and {tuple(gamma.shape)}")
    for name, t in (("x", x), ("gamma", gamma)):
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name} dtype {t.dtype} not built; the kernel "
                             "takes float32 and bfloat16")
        if t.device.type != _DEVICE or t.device != x.device:
            raise ValueError(f"rmsnorm needs CUDA tensors on one device; "
                             f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"rmsnorm needs contiguous operands; {name} "
                             "is not")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    out = torch.empty_like(x)
    if rows == 0:
        return out  # nothing to launch
    vec = _vec_ok(d, (x, gamma, out))
    with _device_stream(x.device) as stream:
        err = _lib().rmsnorm(_DTYPES[x.dtype], _DTYPES[gamma.dtype], rows, d,
                             float(eps), x.data_ptr(), gamma.data_ptr(),
                             out.data_ptr(), int(vec), stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm: CUDA launch failed with cudaError_t "
                           f"{err}")
    with _count_lock:
        launches += 1
    return out
