"""Hopper (sm_90a) CUDA C++ flash attention: the forward and the
backward's dq and dk/dv passes, wrappers over the kernels of
``src/repro_torch/csrc/flash_attention.cu``. That file's header says which
TPU kernel each one replaces (``repro/kernels/flash_attention.py``), what
bounds it on the card and what its design does about that.

Layouts are the JAX kernels': q ``(B, Hq, Sq, D)``, k and v
``(B, Hkv, Sk, D)`` with ``Hq % Hkv == 0``. The batch, head and sequence
dimensions may have any strides; the last one must be dense, so the
decoder's ``(B, S, H, D)`` tensors go in as transposed views without a
copy. float32 or bfloat16 (all operands of one dtype), D in
:data:`HEAD_DIMS`. Outputs are allocated with the layout of the input they
mirror: o and dq like q, dk like k, dv like v. Positions are the row
indices (causal: key k is visible to query q iff k <= q; window w > 0:
iff q - k < w), and every query row must see at least one key.

The library is built by ``nvcc`` at the first call (``_build``) and each
kernel launches on the current CUDA stream without synchronising.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (plain counters; chip_smoke.py zeroes
# them before the main path and reads them after)
fwd_launches = 0
dq_launches = 0
dkv_launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIZES = [_I] * 9             # dtype, D, B, Hq, Hkv, Sq, Sk, causal, window
_VIEW = [_P, _L, _L, _L]      # pointer, batch / head / sequence strides
SIGNATURES = {
    "flash_attention_fwd": _SIZES + _VIEW * 4 + [_P, _P],
    "flash_attention_bwd_dq": _SIZES + _VIEW * 4 + [_P, _P] + _VIEW + [_P],
    "flash_attention_bwd_dkv": (_SIZES + _VIEW * 4 + [_P, _P] + _VIEW * 2
                                + [_P]),
}


def reset_launches() -> None:
    global fwd_launches, dq_launches, dkv_launches
    fwd_launches = dq_launches = dkv_launches = 0


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention", SIGNATURES)


def _view(t: torch.Tensor) -> list:
    return [t.data_ptr(), t.stride(0), t.stride(1), t.stride(2)]


def _sizes(q, k, v, causal, window, *like_q) -> list:
    """Check the operands; returns the kernels' leading int arguments."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash attention wants q (B,Hq,Sq,D) and k, v "
                         f"(B,Hkv,Sk,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (Hq must be a multiple of Hkv)")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not built; kernels take {HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not built; kernels take "
                         "float32 and bfloat16")
    if Sk == 0 and Sq > 0:
        raise ValueError("no keys to attend to")
    for t in (q, k, v, *like_q):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("flash attention kernels need CUDA tensors on "
                             f"one device; got {t.device} and {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"dtype mismatch {t.dtype} vs {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError("the last dimension must be dense (stride 1); "
                             f"got strides {t.stride()}")
    for t in like_q:
        if t.shape != q.shape:
            raise ValueError(f"shape {tuple(t.shape)} != q {tuple(q.shape)}")
    return [_DTYPES[q.dtype], D, B, Hq, Hkv, Sq, Sk, int(causal),
            int(window)]


def _run(fn, args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA launch failed with "
                           f"cudaError_t {err}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Forward: ``(o, lse)``; o in ``q.dtype``, lse ``(B, Hq, Sq)`` f32."""
    global fwd_launches
    sizes = _sizes(q, k, v, causal, window)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _run(_lib().flash_attention_fwd,
             sizes + _view(q) + _view(k) + _view(v) + _view(o)
             + [lse.data_ptr(), stream])
    fwd_launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0):
    """Backward: ``(dq, dk, dv)`` in the dtypes of q, k and v, from the
    forward's ``o`` and ``lse`` and the output gradient ``do``. dk and dv
    are summed over the q heads of each kv group inside the kernel."""
    global dq_launches, dkv_launches
    sizes = _sizes(q, k, v, causal, window, o, do)
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"lse must be float32 {tuple(q.shape[:3])} on "
                         f"{q.device}; got {lse.dtype} {tuple(lse.shape)}")
    lse = lse.contiguous()
    # delta = rowsum(do·o) outside the kernels, as the reference does
    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(-1).contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = _lib()
        common = (sizes + _view(q) + _view(k) + _view(v) + _view(do)
                  + [lse.data_ptr(), delta.data_ptr()])
        _run(lib.flash_attention_bwd_dq, common + _view(dq) + [stream])
        dq_launches += 1
        _run(lib.flash_attention_bwd_dkv,
             common + _view(dk) + _view(dv) + [stream])
        dkv_launches += 1
    return dq, dk, dv
