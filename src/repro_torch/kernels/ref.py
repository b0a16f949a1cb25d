"""Plain PyTorch versions of the port's kernels: the CPU path and the oracle
the CUDA kernels are held against (counterpart of ``repro/kernels/ref.py``).
"""
from __future__ import annotations

import torch


def row_scalars(a, x: torch.Tensor) -> torch.Tensor:
    """Per-row mix coefficient as a float32 tensor on ``x``'s device.

    A 1-D tensor of shape ``(M,)`` is one coefficient per worker row of a
    stacked ``(M, ...)`` buffer; a Python number or 0-d tensor is one
    coefficient for the whole of ``x`` (returned with shape ``(1,)``)."""
    a = torch.as_tensor(a, dtype=torch.float32, device=x.device)
    if a.dim() == 0:
        return a.reshape(1)
    if a.dim() != 1 or x.dim() == 0 or a.shape[0] != x.shape[0]:
        raise ValueError(f"per-worker coefficients of shape {tuple(a.shape)} "
                         f"do not match buffer rows {tuple(x.shape[:1])}")
    return a


def gossip_mix_ref(x, x_recv, upd, alpha, beta, out=None):
    """``α·x + β·x_recv (+ upd)`` in float32, stored in ``x.dtype``.

    ``alpha``/``beta``: scalars, or ``(M,)`` per-worker coefficients
    broadcast over the rows of a stacked ``(M, n)`` buffer. ``upd=None`` is
    the pure-mix variant. ``out`` (may be ``x`` itself) receives the
    result."""
    bshape = (-1,) + (1,) * (x.dim() - 1) if x.dim() else ()
    a = row_scalars(alpha, x).reshape(bshape)
    b = row_scalars(beta, x).reshape(bshape)
    res = a * x.to(torch.float32) + b * x_recv.to(torch.float32)
    if upd is not None:
        res = res + upd.to(torch.float32)
    if out is None:
        return res.to(x.dtype)
    return out.copy_(res)


NEG_INF = -1e30


def _mask(Sq: int, Sk: int, causal: bool, window: int, device):
    """(Sq, Sk) bool: key k is visible to query q. Positions are the row
    indices, as the flash kernels derive them from their tile offsets."""
    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & ((qp - kp) < window)
    return mask


def _scores(q, k, causal, window):
    """Masked f32 scores ``(B, Hkv, G, Sq, Sk)`` of ``q·scale`` against k."""
    B, Hq, Sq, d = q.shape
    _, Hkv, Sk, _ = k.shape
    qh = q.reshape(B, Hkv, Hq // Hkv, Sq, d).to(torch.float32) * d ** -0.5
    s = torch.einsum("bhgqd,bhkd->bhgqk", qh, k.to(torch.float32))
    return torch.where(_mask(Sq, Sk, causal, window, q.device), s,
                       torch.full((), NEG_INF, dtype=s.dtype, device=s.device))


def attention_ref(q, k, v, *, causal=True, window=0):
    """q: (B, Hq, Sq, d); k, v: (B, Hkv, Sk, d). Naive softmax attention,
    the counterpart of ``repro/kernels/ref.py::attention_ref``."""
    B, Hq, Sq, d = q.shape
    p = torch.softmax(_scores(q, k, causal, window), dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    return o.reshape(B, Hq, Sq, d).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """The flash forward's function, plainly: ``(o, lse)`` with o in
    ``q.dtype`` and the f32 log-sum-exp ``(B, Hq, Sq)`` the backward
    recomputes P from. Layouts as :func:`attention_ref`."""
    B, Hq, Sq, d = q.shape
    s = _scores(q, k, causal, window)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    return (o.reshape(B, Hq, Sq, d).to(q.dtype),
            lse.reshape(B, Hq, Sq))


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=0):
    """The flash backward's function, with the Pallas bodies' formulas:
    ``P = exp(s − lse)``, ``delta = rowsum(do·o)``, ``dS = P·(dP − delta)``,
    ``dq = scale·dS·k``, ``dk = dSᵀ·(q·scale)`` and ``dv = Pᵀ·do``, each
    summed over the q heads of a kv group in f32. Returns (dq, dk, dv) in
    the dtypes of q, k and v."""
    B, Hq, Sq, d = q.shape
    _, Hkv, Sk, _ = k.shape
    G = Hq // Hkv
    scale = d ** -0.5

    def grouped(x):
        return x.reshape(B, Hkv, G, Sq, -1).to(torch.float32)

    p = torch.exp(_scores(q, k, causal, window) - grouped(lse))
    do_f = grouped(do)
    delta = (do_f * grouped(o)).sum(-1, keepdim=True)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", do_f, v.to(torch.float32))
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.to(torch.float32)) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, grouped(q) * scale)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, do_f)
    return (dq.reshape(B, Hq, Sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_dkv_sum_ref(part, scale, dtype=torch.bfloat16):
    """The bf16 dk/dv kernel's partial sums added, as its summing kernel
    adds them: ``part`` (2, n, B, Hkv, Sk, D) float32, dk's parts first;
    each sum taken in part order 0, 1, ... in float32, dk times ``scale``,
    both rounded to ``dtype``. Returns (dk, dv)."""
    acc = part[:, 0].clone()
    for j in range(1, part.shape[1]):
        acc += part[:, j]
    return (acc[0] * scale).to(dtype), acc[1].to(dtype)


# ---------------------------------------------------------------------------
# int8 error-feedback wire (counterparts of quantize_plane_ref and
# dequant_mix_ref in the JAX package's ref.py)
# ---------------------------------------------------------------------------


def worker_rows(x: torch.Tensor, what: str = "buffer") -> torch.Tensor:
    """A plane buffer as ``(M, n)``: a 1-D ``(n,)`` buffer is one worker, a
    stacked ``(M, n)`` buffer is M. The quantized layout is per worker."""
    if x.dim() == 1:
        return x[None]
    if x.dim() == 2:
        return x
    raise ValueError(f"{what} must be (n,) or stacked (M, n); got "
                     f"{tuple(x.shape)}")


def _padded_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    """``(M, n)`` → ``(M, rows, 128)`` float32, zero padded past n."""
    from repro_torch.kernels.quantize import LANE
    a = a.to(torch.float32)
    pad = rows * LANE - a.shape[-1]
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
    return a.reshape(a.shape[0], rows, LANE)


def _store(res: torch.Tensor, out):
    return res if out is None else out.copy_(res)


def quantize_plane_ref(x, resid=None, *, out_q=None, out_s=None,
                       out_resid=None):
    """int8 quantization with error feedback, per 128-element row of each
    worker's ``quant_layout(n)`` rows::

        v = x + resid                 (f32)
        s = absmax_row(v) / 127       (1.0 where absmax is 0)
        q = clip(round_half_even(v / s), ±127)
        resid' = v − q·s              (in x's dtype)

    ``x`` is ``(n,)`` or stacked ``(M, n)``; returns ``(q, scales,
    resid')`` with q int8 in x's shape, scales ``(rows,)`` or ``(M,
    rows)`` float32, resid' in x's shape and dtype. ``resid=None`` is a
    zero residual. ``out_*`` receive the results (``out_resid`` may be
    ``resid`` itself).

    ``s`` is a division by a TENSOR of 127s: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which rounds differently
    from the kernel's correctly rounded ``__fdiv_rn``."""
    from repro_torch.kernels.quantize import quant_layout
    x2 = worker_rows(x)
    n = x2.shape[1]
    rows = quant_layout(n)[0]
    v = _padded_rows(x2, rows)
    if resid is not None:
        v = v + _padded_rows(worker_rows(resid, "resid"), rows)
    absmax = torch.amax(v.abs(), dim=-1, keepdim=True)
    scale = torch.where(absmax > 0.0,
                        absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(v / scale), -127.0, 127.0)
    res = v - q * scale
    del v

    def unpad(a, dt):
        return a.reshape(a.shape[0], -1)[:, :n].to(dt).reshape(x.shape)

    s_out = scale.reshape(x2.shape[0], rows)
    if x.dim() == 1:
        s_out = s_out[0]
    return (_store(unpad(q, torch.int8), out_q), _store(s_out, out_s),
            _store(unpad(res, x.dtype), out_resid))


def dequant_mix_ref(x, q, scales, upd, alpha, beta, out=None):
    """``α·x + β·(q·s) [+ upd]`` in float32, stored in x's dtype, in that
    order of operations: ``((α·x) + (β·(q·s))) + upd``.

    ``x`` (and ``q``, ``upd``) are ``(n,)`` with scalar α, β and scales
    ``(rows,)``, or stacked ``(M, n)`` with scalar or ``(M,)`` per-worker
    α, β and scales ``(M, rows)``, as :func:`quantize_plane_ref` makes
    them. ``upd=None`` is the pure mix. ``out`` (may be ``x``) receives the
    result."""
    from repro_torch.kernels.quantize import quant_layout
    x2 = worker_rows(x)
    M, n = x2.shape
    rows = quant_layout(n)[0]
    want = (rows,) if x.dim() == 1 else (M, rows)
    if tuple(scales.shape) != want:
        raise ValueError(f"scales shape {tuple(scales.shape)} does not match "
                         f"the quant layout {want} for n={n}")
    a = row_scalars(alpha, x2)[:, None]
    b = row_scalars(beta, x2)[:, None]
    r = _padded_rows(worker_rows(q, "q"), rows) \
        * scales.reshape(M, rows, 1).to(torch.float32)
    r = r.reshape(M, -1)[:, :n]
    res = a * x2.to(torch.float32) + b * r
    del r
    if upd is not None:
        res = res + worker_rows(upd, "upd").to(torch.float32)
    return _store(res.to(x.dtype).reshape(x.shape), out)


# ---------------------------------------------------------------------------
# RMSNorm and the Mamba2 SSD chunked scan (counterparts of rmsnorm_ref and
# ssd_ref in the JAX package's ref.py, and of the function its ssd_scan
# kernel computes)
# ---------------------------------------------------------------------------


def rmsnorm_ref(x, gamma, eps=1e-5):
    """``x·rsqrt(mean(x²) + eps)·γ`` over the last axis, statistics in
    float32, output in ``x.dtype``."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)
            * gamma.to(torch.float32)).to(x.dtype)


def _ssd_operands(x, dt, A, Bm, Cm):
    """float32 copies of the scan's operands, with shape checks."""
    if x.dim() != 4 or dt.shape != x.shape[:3] or Bm.dim() != 3 \
            or Cm.shape != Bm.shape or Bm.shape[:2] != (x.shape[0],
                                                        x.shape[2]) \
            or A.shape != (x.shape[1],):
        raise ValueError(
            f"ssd_scan wants x (B,H,S,P), dt (B,H,S), A (H,), Bm/Cm "
            f"(B,S,N); got {tuple(x.shape)}, {tuple(dt.shape)}, "
            f"{tuple(A.shape)}, {tuple(Bm.shape)}, {tuple(Cm.shape)}")
    f = torch.float32
    return x.to(f), dt.to(f), A.to(f), Bm.to(f), Cm.to(f)


def ssd_scan_ref(x, dt, A, Bm, Cm, *, chunk=128):
    """The Mamba2 SSD chunked scan, plainly: the arithmetic of the JAX
    package's ``_ssd_kernel`` (``repro/kernels/ssd_scan.py``), all in
    float32, with the chunks' states carried in order. x ``(B, H, S, P)``,
    dt ``(B, H, S)``, A ``(H,)``, Bm/Cm ``(B, S, N)`` (shared across heads)
    → y ``(B, H, S, P)`` in ``x.dtype``. Per chunk of Q steps::

        cum  = inclusive cumsum(dt·A)
        W    = (C·Bᵀ) ⊙ exp(cum_i − cum_j)[i ≥ j] ⊙ dt_j
        y    = W·x + exp(cum)·(C·state)
        state ← state·exp(cum_last) + (B ⊙ exp(cum_last − cum)·dt)ᵀ·x
    """
    B, H, S, P = x.shape
    N = Bm.shape[-1]
    chunk = min(int(chunk), S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"chunk {chunk} must divide S={S}")
    nc = S // chunk
    xf, dtf, Af, Bf, Cf = _ssd_operands(x, dt, A, Bm, Cm)
    xs = xf.reshape(B, H, nc, chunk, P)
    dts = dtf.reshape(B, H, nc, chunk)
    Bs = Bf.reshape(B, 1, nc, chunk, N)
    Cs = Cf.reshape(B, 1, nc, chunk, N)
    cum = torch.cumsum(dts * Af[None, :, None, None], dim=-1)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    # the exponential only where i >= j: above the diagonal cum_i − cum_j
    # is positive and may overflow
    seg = torch.where(causal, cum[..., :, None] - cum[..., None, :], 0.0)
    Lmat = torch.where(causal, torch.exp(seg), 0.0)
    W = (Cs @ Bs.transpose(-1, -2)) * Lmat * dts[..., None, :]
    y = W @ xs                                         # (B, H, nc, Q, P)
    del W, Lmat, seg
    decay_out = torch.exp(cum[..., -1:] - cum) * dts   # (B, H, nc, Q)
    ingest = (Bs * decay_out[..., None]).transpose(-1, -2) @ xs
    state = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    for c in range(nc):
        y[:, :, c] += torch.exp(cum[:, :, c])[..., None] \
            * (Cs[:, :, c] @ state)
        state = state * torch.exp(cum[:, :, c, -1])[..., None, None] \
            + ingest[:, :, c]
    return y.reshape(B, H, S, P).to(x.dtype)


def ssd_ref(x, dt, A, Bm, Cm):
    """Sequential SSD recurrence, the oracle of the scan (tests only).
    Layouts as :func:`ssd_scan_ref`."""
    B, H, S, P = x.shape
    xf, dtf, Af, Bf, Cf = _ssd_operands(x, dt, A, Bm, Cm)
    state = torch.zeros((B, H, Bm.shape[-1], P), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, :, t] * Af[None, :])
        upd = torch.einsum("bn,bhp->bhnp", Bf[:, t],
                           dtf[:, :, t][..., None] * xf[:, :, t])
        state = state * dA[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], state))
    return torch.stack(ys, dim=2).to(x.dtype)
