"""The Mamba2 SSD chunked scan on Hopper: the wrapper over the CUDA C++
kernels of ``src/repro_torch/csrc/ssd_scan.cu``. That file's header says
which TPU kernel they replace (``repro/kernels/ssd_scan.py``), what bounds
them on the card and what the design does about that (chunk-parallel
kernels, the products in 3xTF32 ``mma.sync``, ``cp.async`` tiles).

Layouts are the JAX kernel's: x ``(B, H, S, P)``, dt ``(B, H, S)``, A
``(H,)``, Bm and Cm ``(B, S, N)`` (shared across heads) → y ``(B, H, S,
P)`` in x's dtype. x, Bm and Cm are float32 or bfloat16 (one dtype), dt
float32 or bfloat16, A is cast to float32. Every operand is read through
its strides, so the model's ``(B, S, H, P)`` x and ``(B, S, H)`` dt go in
as transposed views without a copy; the last axis of x, Bm and Cm must be
dense. An x, Bm or Cm whose pointer or strides are not multiples of 16
bytes (:func:`aligned`) is first packed into aligned rows of the workspace
by a kernel of its own, so the others copy every tile by ``cp.async``.
``chunk`` (at most 128, and cut to S) must divide S; N is at most 128.

The library is built by ``nvcc`` at the first call (``_build``). A call
launches two to four CUDA kernels (pack for a misaligned operand, chunk,
state carry when S > 2·chunk, output) on the current CUDA stream without
synchronising, into an f32 workspace it allocates; it counts as one
launch of ``ssd_scan``.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from repro_torch.kernels import _build

MAX_CHUNK = 128
MAX_STATE = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# calls of ssd_scan since the last reset, one a call however many CUDA
# kernels it launches (a plain counter; chip_smoke.py zeroes it before the
# main path and reads it after)
launches = 0
# the counters are bumped from the stream engine's threads too
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SIGNATURES = {
    # dtype, dt dtype, B, H, S, P, N, chunk, aligned (bit 1 x, 2 Bm, 4 Cm:
    # 16-byte copies); x + 3 strides, dt + 3 strides, A, Bm + 2 strides,
    # Cm + 2 strides, y + 3 strides, f32 workspace, stream
    "ssd_scan": [_I, _I] + [_L] * 6 + [_I] + [_P, _L, _L, _L] * 2 + [_P]
    + [_P, _L, _L] * 2 + [_P, _L, _L, _L, _P, _P],
    # B, H, S, P, N, chunk, aligned; floats of the workspace (out)
    "ssd_scan_workspace": [_L] * 6 + [_I, _P],
    # dtype, B, H, S, P, N, chunk, aligned; 13 int64 (out): CUDA kernels a
    # call, then blocks, threads, dynamic shared memory of the pack, chunk,
    # state and output kernels
    "ssd_scan_config": [_I] + [_L] * 6 + [_I, _P],
}
KERNELS = ("ssd_pack_kernel", "ssd_chunk_kernel", "ssd_state_kernel",
           "ssd_out_kernel")
# the device type the kernels run on (tests of the argument lists swap it)
_DEVICE = "cuda"


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    return _build.load("ssd_scan", SIGNATURES)


def _run(fn, args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA launch failed with "
                           f"cudaError_t {err}")


@contextlib.contextmanager
def _device_stream(device):
    """``device`` made current; yields its current CUDA stream's handle."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream().cuda_stream


def aligned(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the kernels' 16-byte copies: its pointer and the
    stride of each dimension but the last that is longer than 1 are
    multiples of 16 bytes (the launcher checks the same)."""
    b = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or s * b % 16 == 0 for n, s in zip(t.shape[:-1], t.stride()))


def _aligned_bits(x, Bm, Cm) -> int:
    """The ``aligned`` argument: bit i set when operand i (x, Bm, Cm) takes
    the 16-byte copies."""
    return sum(1 << i for i, t in enumerate((x, Bm, Cm)) if aligned(t))


def launch_config(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, *,
                  chunk: int = 128) -> dict:
    """``{"kernels": n, kernel: {"blocks", "threads", "smem_bytes"}}``: the
    CUDA kernels a call on these operands launches and each one's grid,
    block and dynamic shared memory, as the library launches them (blocks
    0: not launched; the pack kernel runs for a misaligned operand, the
    state kernel with more than two chunks)."""
    B, H, S, P = x.shape
    out = (ctypes.c_int64 * 13)()
    _run(_lib().ssd_scan_config, [_DTYPES[x.dtype], B, H, S, P,
                                  Bm.shape[-1], min(int(chunk), S),
                                  _aligned_bits(x, Bm, Cm), out])
    cfg = {"kernels": out[0]}
    for k, name in enumerate(KERNELS):
        cfg[name] = {"blocks": out[1 + 3 * k], "threads": out[2 + 3 * k],
                     "smem_bytes": out[3 + 3 * k]}
    return cfg


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """Launch the SSD kernels (see the module's docstring): y as
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
        if t.device.type != _DEVICE or t.device != x.device:
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
    lib = _lib()
    bits = _aligned_bits(x, Bm, Cm)
    floats = ctypes.c_int64()
    _run(lib.ssd_scan_workspace, [B, H, S, P, N, chunk, bits,
                                  ctypes.byref(floats)])
    work = torch.empty(floats.value, dtype=torch.float32, device=x.device)
    with _device_stream(x.device) as stream:
        _run(lib.ssd_scan, [
            _DTYPES[x.dtype], _DTYPES[dt.dtype], B, H, S, P, N, chunk, bits,
            x.data_ptr(), *x.stride()[:3], dt.data_ptr(), *dt.stride(),
            A32.data_ptr(), Bm.data_ptr(), *Bm.stride()[:2], Cm.data_ptr(),
            *Cm.stride()[:2], y.data_ptr(), *y.stride()[:3], work.data_ptr(),
            stream])
    with _count_lock:
        launches += 1
    return y
