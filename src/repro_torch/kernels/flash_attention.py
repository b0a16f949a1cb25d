"""Hopper (sm_90a) CUDA C++ flash attention: the forward and the
backward's dq and dk/dv passes, wrappers over the kernels of
``src/repro_torch/csrc/flash_attention.cu``. That file's header says which
TPU kernel each one replaces (``repro/kernels/flash_attention.py``), what
bounds it on the card and what its design does about that (float32:
3xTF32 ``mma.sync`` products; bfloat16: bf16 ``mma.sync`` m16n8k16 fed by
``ldmatrix``, P and dS split in two bf16 terms; both: 16-byte ``cp.async``
copies into a 2-stage ring).

Layouts are the JAX kernels': q ``(B, Hq, Sq, D)``, k and v
``(B, Hkv, Sk, D)`` with ``Hq % Hkv == 0``. The batch, head and sequence
dimensions may have any strides; the last one must be dense, so the
decoder's ``(B, S, H, D)`` tensors go in as transposed views without a
copy. An operand whose pointer or strides are not multiples of 16 bytes
(:func:`aligned`) is copied element by element inside the same kernels.
float32 or bfloat16 (all operands of one dtype), D in :data:`HEAD_DIMS`.
Outputs are allocated with the layout of the input they mirror: o and dq
like q, dk like k, dv like v. Positions are the row indices (causal: key k
is visible to query q iff k <= q; window w > 0: iff q - k < w), and every
query row must see at least one key.

The library is built by ``nvcc`` at the first call (``_build``) and each
kernel launches on the current CUDA stream without synchronising. The
backward is two launches: the dq kernel also writes delta = rowsum(do·o)
to a buffer the dk/dv kernel reads. In bfloat16, where the dk/dv grid
would not fill the card (:func:`dkv_split`), the dk/dv kernel splits each
key tile's work in parts that write float32 partial sums, and a third
kernel adds them in a fixed order (``dkv_sum_launches``).
"""
from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (plain counters; chip_smoke.py zeroes
# them before the main path and reads them after)
fwd_launches = 0
dq_launches = 0
dkv_launches = 0
# the bf16 dk/dv partial sums' adds (only where dkv_split > 1); dkv_launches
# counts the dk/dv kernel itself, once a backward as before
dkv_sum_launches = 0
# the counters are bumped from the stream engine's threads too
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# dtype, D, B, Hq, Hkv, Sq, Sk, causal, window, aligned (bit 1 q, 2 k, 4 v,
# 8 do: the operand takes 16-byte copies)
_SIZES = [_I] * 10
_VIEW = [_P, _L, _L, _L]      # pointer, batch / head / sequence strides
SIGNATURES = {
    # q, k, v, o; lse; stream
    "flash_attention_fwd": _SIZES + _VIEW * 4 + [_P, _P],
    # q, k, v, do, o; lse, delta (written); dq; stream
    "flash_attention_bwd_dq": _SIZES + _VIEW * 5 + [_P, _P] + _VIEW + [_P],
    # q, k, v, do; lse, delta (read); dk, dv; nsplit, part; stream
    "flash_attention_bwd_dkv": (_SIZES + _VIEW * 4 + [_P, _P] + _VIEW * 2
                                + [_I, _P, _P]),
    # dtype, D, B, Hkv, Sk, nsplit; part; dk, dv; stream
    "flash_attention_dkv_sum": [_I] * 6 + [_P] + _VIEW * 2 + [_P],
    # kind (0 fwd, 1 dq, 2 dk/dv), dtype, D; warpgroups, smem bytes (out)
    "flash_attention_config": [_I, _I, _I, _P, _P],
}
# each dtype's kernels: forward, dq, dk/dv (the kinds of flash_attention_config)
KERNELS = {
    torch.float32: ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                    "flash_bwd_dkv_kernel"),
    torch.bfloat16: ("flash_fwd_bf16_kernel", "flash_bwd_dq_bf16_kernel",
                     "flash_bwd_dkv_bf16_kernel"),
}
BQ = BK = 64  # query and key rows of the kernels' tiles
# the device type the kernels run on (tests of the argument lists swap it)
_DEVICE = "cuda"


def reset_launches() -> None:
    global fwd_launches, dq_launches, dkv_launches, dkv_sum_launches
    fwd_launches = dq_launches = dkv_launches = dkv_sum_launches = 0


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention", SIGNATURES)


def launch_config(dtype: torch.dtype, D: int) -> dict:
    """``{kernel: {"threads": n, "smem_bytes": b}}``: each kernel's block
    (128 threads a warpgroup) and dynamic shared memory for (dtype, D), as
    the library launches them."""
    lib, out = _lib(), {}
    for kind, name in enumerate(KERNELS[dtype]):
        wg, smem = ctypes.c_int(), ctypes.c_int()
        _run(lib.flash_attention_config, [kind, _DTYPES[dtype], D,
                                          ctypes.byref(wg),
                                          ctypes.byref(smem)])
        out[name] = {"threads": 128 * wg.value, "smem_bytes": smem.value}
    return out


def dkv_split(B: int, Hq: int, Hkv: int, Sq: int, Sk: int, dtype,
              sm_count: int) -> int:
    """The parts the bf16 dk/dv kernel splits each key tile's G·nq
    iterations into (G = Hq / Hkv query heads, nq query tiles): 1 for
    float32; else the most that keep the grid of B·Hkv·ceil(Sk/64)·parts
    blocks within one wave of one block an SM (the kernel's occupancy) on
    ``sm_count`` SMs, and at most one part for every two iterations (a
    block's two warpgroups take one each)."""
    if dtype != torch.bfloat16:
        return 1
    blocks = B * Hkv * -(-Sk // BK)
    iters = Hq // Hkv * -(-Sq // BQ)
    return max(1, min(sm_count // max(blocks, 1), iters // 2))


_SM_COUNT: dict = {}


def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA device (cached)."""
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def _view(t: torch.Tensor) -> list:
    return [t.data_ptr(), t.stride(0), t.stride(1), t.stride(2)]


def aligned(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the kernels' 16-byte copies: its pointer and the
    stride of each of its (B, H, S) dimensions longer than 1 are multiples
    of 16 bytes (the launcher checks the same)."""
    b = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or s * b % 16 == 0 for n, s in zip(t.shape[:3], t.stride()[:3]))


def _aligned_bits(*ops) -> int:
    """The ``aligned`` argument: bit i set when operand i (q, k, v, do)
    takes the 16-byte copies."""
    return sum(1 << i for i, t in enumerate(ops) if aligned(t))


@contextlib.contextmanager
def _device_stream(device):
    """``device`` made current; yields its current CUDA stream's handle."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream().cuda_stream


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
        if t.device.type != _DEVICE or t.device != q.device:
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
    sizes = _sizes(q, k, v, causal, window) + [_aligned_bits(q, k, v)]
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    with _device_stream(q.device) as stream:
        _run(_lib().flash_attention_fwd,
             sizes + _view(q) + _view(k) + _view(v) + _view(o)
             + [lse.data_ptr(), stream])
    with _count_lock:
        fwd_launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0):
    """Backward: ``(dq, dk, dv)`` in the dtypes of q, k and v, from the
    forward's ``o`` and ``lse`` and the output gradient ``do``. Two
    launches: dq (which also writes delta = rowsum(do·o)), then dk/dv,
    summed over the q heads of each kv group inside the kernel; in
    bfloat16 a third (:func:`dkv_sum`) where :func:`dkv_split` is past
    1."""
    global dq_launches, dkv_launches
    sizes = _sizes(q, k, v, causal, window, o, do) + [
        _aligned_bits(q, k, v, do)]
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"lse must be float32 {tuple(q.shape[:3])} on "
                         f"{q.device}; got {lse.dtype} {tuple(lse.shape)}")
    lse = lse.contiguous()
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    nsplit = 1 if q.dtype != torch.bfloat16 else dkv_split(
        B, Hq, Hkv, Sq, Sk, q.dtype, sm_count(q.device))
    part = None if nsplit == 1 else torch.empty(
        (2, nsplit, B, Hkv, Sk, D), dtype=torch.float32, device=q.device)
    with _device_stream(q.device) as stream:
        lib = _lib()
        views = _view(q) + _view(k) + _view(v) + _view(do)
        rows = [lse.data_ptr(), delta.data_ptr()]
        _run(lib.flash_attention_bwd_dq,
             sizes + views + _view(o) + rows + _view(dq) + [stream])
        with _count_lock:
            dq_launches += 1
        _run(lib.flash_attention_bwd_dkv,
             sizes + views + rows + _view(dk) + _view(dv)
             + [nsplit, 0 if part is None else part.data_ptr(), stream])
        with _count_lock:
            dkv_launches += 1
    if part is not None:
        dkv_sum(part, dk, dv)
    return dq, dk, dv


def dkv_sum(part, dk, dv) -> None:
    """dk = scale · Σ_j part[0, j] and dv = Σ_j part[1, j] (scale =
    D^-0.5), added in part order and written in bf16 into ``dk`` and
    ``dv``: the bf16 backward's last launch where :func:`dkv_split` is past
    1. ``part`` is the dk/dv kernel's dense float32 (2, n, B, Hkv, Sk, D)
    buffer of partial sums, n > 1."""
    global dkv_sum_launches
    _, n, B, Hkv, Sk, D = part.shape
    if (part.dtype != torch.float32 or not part.is_contiguous() or n < 2
            or dk.shape != dv.shape or dk.shape != part.shape[2:]
            or dk.dtype != torch.bfloat16 or dv.dtype != torch.bfloat16
            or dk.stride(-1) != 1 or dv.stride(-1) != 1
            or any(t.device != part.device or t.device.type != _DEVICE
                   for t in (dk, dv))):
        raise ValueError("dkv_sum wants dense float32 parts (2, n > 1, B, "
                         "Hkv, Sk, D) and bf16 dk, dv (B, Hkv, Sk, D) with "
                         "a dense last dimension, on one CUDA device")
    with _device_stream(part.device) as stream:
        _run(_lib().flash_attention_dkv_sum,
             [1, D, B, Hkv, Sk, n, part.data_ptr()] + _view(dk) + _view(dv)
             + [stream])
    with _count_lock:
        dkv_sum_launches += 1
