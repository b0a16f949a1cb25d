"""Hopper (sm_90) Triton kernel for LayUp's fused push-sum mix + update.

Replaces the TPU kernel ``repro/kernels/gossip_mix.py::gossip_mix`` (Pallas
bodies ``_mix_kernel``/``_mix_kernel_pure``). The function, per element of a
stacked ``(M, n)`` layer-group buffer, row ``i`` = worker ``i``::

    out = α_i·x + β_i·x_recv (+ upd)      in float32, stored in x.dtype

What bounds it on an H100: device memory. The fused variant reads three
operands and writes one (16 B per float32 element), the pure variant
(``upd=None``) reads two and writes one (12 B); at the data-sheet 3.35 TB/s
a GPT-2 Medium plane at M=4 (1.82e9 elements) cannot take less than 8.7 ms.
Four flops per element put it three orders of magnitude below the compute
roof, so the design only has to stream bytes:

* one pass, no intermediates: the Pallas version's (8·tile, 128) padding
  becomes a masked tail, so no padded copy is ever made;
* a 2-D grid of (block of n, worker); each program loads its worker's α/β
  from ``(M,)`` float32 DEVICE tensors, so the push-sum weights never cross
  to the host (no ``.item()``, no sync per step);
* ``HAS_UPD`` is a ``tl.constexpr``, so the pure variant never streams a
  zeros buffer;
* offsets are int64: the GPT-2 Medium ``blocks`` buffer alone is 1.61e9
  elements at M=4, 75% of 2^31.

The ring hop stays a separate ``torch.roll`` (one extra plane copy) for now;
reading the peer's row in place inside the kernel is a later optimisation.

``triton`` is imported when the kernel is first built, inside the launching
function, so the module imports on machines without it. Its compile cache
goes to ``TRITON_CACHE_DIR``, by default ``<repo>/build/triton``.
"""
from __future__ import annotations

import os
import threading
from pathlib import Path

import torch

from repro_torch.kernels.ref import row_scalars

BLOCK = 4096
NUM_WARPS = 8

# kernel launches since the last reset (a plain counter; chip_smoke.py
# zeroes it before the main path and reads it after)
launches = 0
# guards the counter and the one-time build: the stream engine's threads
# launch the kernel too
_lock = threading.Lock()

# bound to ``triton.language`` when the kernel is first built; the kernel
# body below resolves ``tl`` through this module's globals at compile time
tl = None
_KERNEL = None


def _mix_kernel(x_ptr, r_ptr, u_ptr, o_ptr, a_ptr, b_ptr, n,
                HAS_UPD: tl.constexpr, BLOCK: tl.constexpr):
    blk = tl.program_id(0)
    row = tl.program_id(1)
    a = tl.load(a_ptr + row)
    b = tl.load(b_ptr + row)
    offs = blk.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    idx = row.to(tl.int64) * n + offs
    x = tl.load(x_ptr + idx, mask=mask, other=0.0).to(tl.float32)
    r = tl.load(r_ptr + idx, mask=mask, other=0.0).to(tl.float32)
    out = a * x + b * r
    if HAS_UPD:
        out = out + tl.load(u_ptr + idx, mask=mask, other=0.0).to(tl.float32)
    tl.store(o_ptr + idx, out.to(o_ptr.dtype.element_ty), mask=mask)


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def _kernel():
    """Build (once per process) and return the jitted Triton kernel."""
    global tl, _KERNEL
    with _lock:
        if _KERNEL is None:
            os.environ.setdefault("TRITON_CACHE_DIR",
                                  str(_repo_root() / "build" / "triton"))
            import triton
            import triton.language

            tl = triton.language
            _KERNEL = triton.jit(_mix_kernel)
    return _KERNEL


def reset_launches() -> None:
    global launches
    launches = 0


def gossip_mix(x: torch.Tensor, x_recv: torch.Tensor, upd, alpha, beta,
               out=None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns ``out`` (fresh if
    ``None``; it may be ``x`` itself: each element is read before it is
    written, by the same program).

    ``x``, ``x_recv`` (and ``upd`` unless ``None``, and ``out``) must be
    contiguous CUDA tensors of one shape; ``out`` also of ``x``'s dtype.
    ``alpha``/``beta``: ``(M,)`` per-worker device tensors for a stacked
    ``(M, ...)`` buffer, or scalars for one row."""
    global launches
    if out is None:
        out = torch.empty_like(x)
    elif out.dtype != x.dtype:
        raise ValueError(f"out dtype {out.dtype} != {x.dtype}")
    operands = [x, x_recv, out] + ([upd] if upd is not None else [])
    for t in operands:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError("gossip_mix kernel needs CUDA tensors on one "
                             f"device; got {t.device} and {x.device}")
        if t.shape != x.shape:
            raise ValueError(f"shape mismatch {tuple(t.shape)} vs "
                             f"{tuple(x.shape)}")
        if not t.is_contiguous():
            raise ValueError("gossip_mix kernel needs contiguous operands")
        if not t.dtype.is_floating_point:
            raise ValueError(f"unsupported dtype {t.dtype}")
    a = row_scalars(alpha, x).contiguous()
    b = row_scalars(beta, x).contiguous()
    rows = a.shape[0]
    if b.shape[0] != rows:
        raise ValueError("alpha and beta must have the same shape")
    n = x.numel() // rows
    if x.numel() == 0:
        return out
    kernel = _kernel()
    grid = (-(-n // BLOCK), rows)
    kernel[grid](x, x_recv, upd if upd is not None else x, out, a, b, n,
                 HAS_UPD=upd is not None, BLOCK=BLOCK, num_warps=NUM_WARPS)
    with _lock:
        launches += 1
    return out
