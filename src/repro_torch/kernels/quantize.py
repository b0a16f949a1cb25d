"""The int8 error-feedback gossip wire on Hopper: the quantized layout and
the wrappers over the CUDA C++ kernels of
``src/repro_torch/csrc/quantize.cu`` (DESIGN.md §14). That file's header
says which TPU kernel each one replaces (``repro/kernels/quantize.py``),
what bounds it on the card and what its design does about that.

``quantize_plane`` compresses a plane buffer to int8 with one float32 scale
per 128-element row, carrying the quantization error forward as a
residual; ``dequant_mix`` is the receive side fused with the push-sum mix
and, optionally, the local update: ``α·x + β·(q·s) [+ upd]``. Both take a
1-D ``(n,)`` buffer or a stacked ``(M, n)`` one; the row layout is per
worker (``quant_layout(n)`` rows each), so rows never straddle workers.

The library is built by ``nvcc`` at the first call (``_build``) and each
kernel launches on the current CUDA stream without synchronising.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import row_scalars, worker_rows

# the layout, copied from repro/kernels/quantize.py (that module imports jax)
LANE = 128
SUBLANE_I8 = 32  # int8 min tile is (32, 128); 32 also covers f32/bf16 tiles


def quant_layout(n: int, tile_rows: int = 256):
    """(rows, tile, ntiles) of the padded (rows, 128) view of an
    ``n``-element buffer — ``rows`` is also the number of f32 scales on
    the wire (``plane_nbytes(wire="int8")`` accounting)."""
    rows_total = -(-n // LANE)
    rows_total = -(-rows_total // SUBLANE_I8) * SUBLANE_I8
    tile = min(int(tile_rows), rows_total)
    ntiles = -(-rows_total // tile)
    return ntiles * tile, tile, ntiles


def quant_wire_nbytes(n: int, tile_rows: int = 256) -> int:
    """Bytes on the wire for one quantized ``n``-element buffer:
    int8 payload + f32 per-row scales."""
    rows, _, _ = quant_layout(n, tile_rows)
    return n + 4 * rows


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (plain counters; chip_smoke.py zeroes
# them before the main path and reads them after)
quantize_launches = 0
dequant_mix_launches = 0
# the counters are bumped from the stream engine's threads too
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SIGNATURES = {
    # dtype, M, n, rows, x, r, q, s, r_out, stream
    "quantize_plane": [_I, _L, _L, _L, _P, _P, _P, _P, _P, _P],
    # dtype, with_upd, M, n, rows, x, q, s, u, alpha, beta, out, stream
    "dequant_mix": [_I, _I, _L, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P],
}


def reset_launches() -> None:
    global quantize_launches, dequant_mix_launches
    quantize_launches = dequant_mix_launches = 0


def _lib() -> ctypes.CDLL:
    return _build.load("quantize", SIGNATURES)


def _check(x: torch.Tensor, tensors: dict) -> None:
    """Every operand a contiguous CUDA tensor on x's device."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"dtype {x.dtype} not built; kernels take float32 "
                         "and bfloat16")
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"quantize kernels need CUDA tensors on one "
                             f"device; {name} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"quantize kernels need contiguous operands; "
                             f"{name} is not")


def _want(t, name, shape, dtype):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} {tuple(shape)}; got "
                         f"{t.dtype} {tuple(t.shape)}")


def _run(fn, args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA launch failed with "
                           f"cudaError_t {err}")


def _layout(x: torch.Tensor):
    """(M, n, rows, scales shape) of a 1-D or stacked buffer."""
    if x.dim() not in (1, 2):
        raise ValueError(f"buffer must be (n,) or stacked (M, n); got "
                         f"{tuple(x.shape)}")
    M, n = (1, x.shape[0]) if x.dim() == 1 else tuple(x.shape)
    rows = quant_layout(n)[0]
    return M, n, rows, ((rows,) if x.dim() == 1 else (M, rows))


def quantize_plane(x: torch.Tensor, resid=None, *, out_q=None, out_s=None,
                   out_resid=None):
    """Launch ``quantize_plane_kernel``: returns ``(q, scales, resid')``
    as :func:`repro_torch.kernels.ref.quantize_plane_ref` does. ``resid``
    (``None``: zero) must have x's shape and dtype; ``out_*`` are
    allocated when ``None``, and ``out_resid`` may be ``resid`` itself."""
    global quantize_launches
    M, n, rows, s_shape = _layout(x)
    if out_q is None:
        out_q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if out_s is None:
        out_s = torch.empty(s_shape, dtype=torch.float32, device=x.device)
    if out_resid is None:
        out_resid = torch.empty_like(x)
    ops = {"x": x, "out_q": out_q, "out_s": out_s, "out_resid": out_resid}
    if resid is not None:
        ops["resid"] = resid
        _want(resid, "resid", x.shape, x.dtype)
    _check(x, ops)
    _want(out_q, "out_q", x.shape, torch.int8)
    _want(out_s, "out_s", s_shape, torch.float32)
    _want(out_resid, "out_resid", x.shape, x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _run(_lib().quantize_plane,
             [_DTYPES[x.dtype], M, n, rows, x.data_ptr(),
              None if resid is None else resid.data_ptr(),
              out_q.data_ptr(), out_s.data_ptr(), out_resid.data_ptr(),
              stream])
    with _count_lock:
        quantize_launches += 1
    return out_q, out_s, out_resid


def dequant_mix(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                upd, alpha, beta, out=None) -> torch.Tensor:
    """Launch ``dequant_mix_kernel``: ``α·x + β·(q·s) [+ upd]`` as
    :func:`repro_torch.kernels.ref.dequant_mix_ref`. ``alpha``/``beta``:
    ``(M,)`` per-worker device tensors for a stacked buffer, or scalars.
    ``out`` (fresh if ``None``) may be ``x`` itself."""
    global dequant_mix_launches
    M, n, rows, s_shape = _layout(x)
    if out is None:
        out = torch.empty_like(x)
    ops = {"x": x, "q": q, "scales": scales, "out": out}
    if upd is not None:
        ops["upd"] = upd
        _want(upd, "upd", x.shape, x.dtype)
    _check(x, ops)
    _want(q, "q", x.shape, torch.int8)
    if tuple(scales.shape) != s_shape:
        raise ValueError(f"scales shape {tuple(scales.shape)} does not match "
                         f"the quant layout {s_shape} for n={n}")
    _want(scales, "scales", s_shape, torch.float32)
    _want(out, "out", x.shape, x.dtype)
    x2 = worker_rows(x)
    a = row_scalars(alpha, x2).expand(M).contiguous()
    b = row_scalars(beta, x2).expand(M).contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _run(_lib().dequant_mix,
             [_DTYPES[x.dtype], int(upd is not None), M, n, rows,
              x.data_ptr(), q.data_ptr(), scales.data_ptr(),
              None if upd is None else upd.data_ptr(), a.data_ptr(),
              b.data_ptr(), out.data_ptr(), stream])
    with _count_lock:
        dequant_mix_launches += 1
    return out
