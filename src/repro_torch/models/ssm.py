"""Mamba2-style SSD (state-space duality) block (port of
``repro/models/ssm.py``).

Chunked "dual form" for training and prefill, exact recurrence for
single-token decode and as the chunked form's oracle. The
chunked form is the function the ``ssd_scan`` kernel computes; the model
runs it in plain PyTorch, as the reference's model runs its jnp form.

Layout conventions (the reference's):
  x_ssm : (B, S, H, P)   heads H = d_inner / head_dim P
  dt    : (B, S, H)      post-softplus step sizes, float32
  A     : (H,)           negative decay rates (-exp(A_log)), float32
  Bm/Cm : (B, S, N)      shared across heads (ngroups=1), N = ssm_state

Dtypes follow the reference. Where it multiplies with
``preferred_element_type=float32``, both operands are cast to float32
first (a bf16 product is exact in float32), and where it casts an operand
to ``x.dtype`` before such a product (W, the state weights, the decays and
the entering states), so does the port. Elsewhere mixed operands promote
as jnp promotes them.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec, rmsnorm

_F32 = torch.float32


def ssm_specs(cfg, prefix_layers: Tuple[int, ...] = ()):
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    w = cfg.ssm_conv
    L = prefix_layers
    La = tuple("layers" for _ in L)
    conv_dim = di + 2 * n
    return {
        "in_proj_z": ParamSpec(L + (d, di), La + ("embed", "inner")),
        "in_proj_x": ParamSpec(L + (d, di), La + ("embed", "inner")),
        "in_proj_B": ParamSpec(L + (d, n), La + ("embed", None)),
        "in_proj_C": ParamSpec(L + (d, n), La + ("embed", None)),
        "in_proj_dt": ParamSpec(L + (d, h), La + ("embed", "inner")),
        "dt_bias": ParamSpec(L + (h,), La + ("inner",), init="zeros"),
        "conv_w": ParamSpec(L + (w, conv_dim), La + (None, "inner"),
                            scale=1.0 / np.sqrt(w)),
        "conv_b": ParamSpec(L + (conv_dim,), La + ("inner",), init="zeros"),
        "A_log": ParamSpec(L + (h,), La + ("inner",), init="zeros"),
        "D": ParamSpec(L + (h,), La + ("inner",), init="ones"),
        "gate_norm": ParamSpec(L + (di,), La + ("inner",), init="ones"),
        "out_proj": ParamSpec(L + (di, d), La + ("inner", "embed"),
                              init="scaled",
                              scale=0.02 / np.sqrt(max(2 * cfg.num_layers, 1))),
    }


def _f32_einsum(spec, *operands):
    """``jnp.einsum(..., preferred_element_type=float32)``: the operands
    cast to float32, the product summed in float32."""
    return torch.einsum(spec, *(t.to(_F32) for t in operands))


# ---------------------------------------------------------------------------
# chunked SSD (train)
# ---------------------------------------------------------------------------


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk=128, init_state=None):
    """Returns (y, final_state); y in x's dtype and layout (B, S, H, P),
    final_state (B, H, N, P) in x's dtype."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    chunk = min(chunk, l)
    if l % chunk:
        raise ValueError(f"chunk {chunk} must divide the sequence {l}")
    nc = l // chunk

    xs = x.reshape(b, nc, chunk, h, p)
    dts = dt.reshape(b, nc, chunk, h)
    Bs = Bm.reshape(b, nc, chunk, n)
    Cs = Cm.reshape(b, nc, chunk, n)

    dA = dts * A  # (b, nc, q, h), negative
    cum = torch.cumsum(dA, dim=2)  # inclusive within-chunk cumsum

    # ---- intra-chunk (dual / attention-like form) --------------------------
    # decay from step j to step i (i >= j): exp(cum_i - cum_j), with the
    # exponent summed as a segment, sum_{j<k<=i} dA_k (0 where i < j), not
    # as the difference of two cumsums. Both are the reference's value;
    # the difference loses the exponent's low bits once |cum| is large (and
    # the gradient in A with them), and above the diagonal it is positive
    # and may overflow, which the reference's masked inf turns into a NaN
    # gradient.
    ones = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device)
    causal = ones.tril()[None, None, :, :, None]  # i >= j
    after_j = ones.tril(-1)[None, None, :, :, None]  # k > j
    seg = torch.cumsum(torch.where(after_j, dA[:, :, :, None, :], 0.0),
                       dim=2)  # (b,nc,i,j,h)
    Lmat = torch.where(causal, torch.exp(seg), 0.0)
    CB = _f32_einsum("bcin,bcjn->bcij", Cs, Bs)  # (b,nc,i,j)
    W = CB[..., None] * Lmat * dts[:, :, None, :, :]  # (b,nc,i,j,h)
    y_intra = _f32_einsum("bcijh,bcjhp->bcihp", W.to(x.dtype), xs)

    # ---- chunk states -------------------------------------------------------
    last = cum[:, :, -1:, :]  # (b,nc,1,h)
    decay_to_end = torch.exp(seg[:, :, -1])  # (b,nc,q,h): exp(last - cum)
    # S[b,c,h,n,p] = sum_j decay_j * dt_j * B_j ⊗ x_j
    wts = (decay_to_end * dts).to(x.dtype)
    S = _f32_einsum("bcqh,bcqn,bcqhp->bchnp", wts, Bs, xs)

    # ---- inter-chunk recurrence over chunk states ---------------------------
    chunk_decay = torch.exp(last[:, :, 0, :])  # (b,nc,h) total decay per chunk
    carry = (torch.zeros((b, h, n, p), dtype=_F32, device=x.device)
             if init_state is None else init_state.to(_F32))
    entering = []  # the state entering each chunk
    for c in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + S[:, c]
    final = carry
    entering = torch.stack(entering, dim=1)  # (b,nc,h,n,p)

    # ---- inter-chunk contribution -------------------------------------------
    decay_from_start = torch.exp(cum)  # (b,nc,q,h) decay from chunk start to i
    y_inter = _f32_einsum("bcqn,bcqh,bchnp->bcqhp", Cs,
                          decay_from_start.to(x.dtype),
                          entering.to(x.dtype))

    y = (y_intra + y_inter).reshape(b, l, h, p).to(x.dtype)
    return y, final.to(x.dtype)


def ssd_recurrent_step(state, x_t, dt_t, A, B_t, C_t):
    """One recurrence step. state: (B,H,N,P); x_t: (B,H,P); dt_t: (B,H);
    B_t/C_t: (B,N). Returns (y_t, new_state)."""
    dA = torch.exp(dt_t * A)  # (B,H)
    xw = dt_t[..., None] * x_t
    ct = torch.promote_types(B_t.dtype, xw.dtype)
    upd = torch.einsum("bn,bhp->bhnp", B_t.to(ct), xw.to(ct))
    new = state * dA[:, :, None, None] + upd.to(state.dtype)
    ct = torch.promote_types(C_t.dtype, new.dtype)
    y = torch.einsum("bn,bhnp->bhp", C_t.to(ct), new.to(ct))
    return y.to(x_t.dtype), new


def ssd_reference(x, dt, A, Bm, Cm, init_state=None):
    """Oracle of :func:`ssd_chunked`: the step-by-step recurrence (slow,
    exact). Returns (y, final_state) in x's dtype."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    state = (torch.zeros((b, h, n, p), dtype=_F32, device=x.device)
             if init_state is None else init_state.to(_F32))
    ys = []
    for t in range(l):
        y, state = ssd_recurrent_step(state, x[:, t], dt[:, t], A,
                                      Bm[:, t], Cm[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), state.to(x.dtype)


# ---------------------------------------------------------------------------
# full block
# ---------------------------------------------------------------------------


def _conv_causal(xBC, w, b, tail=None):
    """Depthwise causal conv, width K, as a sum of K shifted products (not
    ``F.conv1d``, which cuDNN may run in TF32). xBC: (B, S, C); w: (K, C).
    tail: (B, K-1, C) previous inputs (chaining)."""
    K = w.shape[0]
    if tail is None:
        tail = torch.zeros(xBC.shape[:1] + (K - 1,) + xBC.shape[2:],
                           dtype=xBC.dtype, device=xBC.device)
    full = torch.cat([tail, xBC], dim=1)  # (B, S+K-1, C)
    out = sum(full[:, i:i + xBC.shape[1]] * w[i] for i in range(K))
    new_tail = full[:, full.shape[1] - (K - 1):] if K > 1 else tail
    return out + b, new_tail


def ssm_mixer_inputs(p, x, cfg, *, conv_tail=None):
    """The block's input projections, conv and activations up to the
    mixer: returns ``(x_ssm, dt, A, Bm, Cm, z, new_tail)`` with x_ssm
    (B, S, H, P), dt (B, S, H) float32, A (H,) float32, Bm/Cm (B, S, N)
    and the gate z (B, S, d_inner)."""
    B_, S, _ = x.shape
    di, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z = x @ p["in_proj_z"]
    xBC = torch.cat([x @ p["in_proj_x"], x @ p["in_proj_B"],
                     x @ p["in_proj_C"]], dim=-1)
    dt_raw = x @ p["in_proj_dt"] + p["dt_bias"]
    dt = F.softplus(dt_raw.to(_F32))
    xBC, new_tail = _conv_causal(xBC, p["conv_w"], p["conv_b"], conv_tail)
    xBC = F.silu(xBC)
    x_ssm = xBC[..., :di].reshape(B_, S, h, pd)
    Bm = xBC[..., di:di + n]
    Cm = xBC[..., di + n:]
    A = -torch.exp(p["A_log"].to(_F32))
    return x_ssm, dt, A, Bm, Cm, z, new_tail


def ssm_gate_input(p, y, x_ssm, z):
    """The gate norm's input: the mixer's y (B, S, H, P) plus the D skip,
    flattened to (B, S, d_inner) and gated by silu(z)."""
    y = y + p["D"][None, None, :, None] * x_ssm
    return y.reshape(z.shape) * F.silu(z)


def ssm_block_apply(p, x, cfg, *, init_state=None, conv_tail=None,
                    return_state=False, chunk=128):
    """x: (B, S, d_model) → (B, S, d_model) [+ (state, conv_tail)]."""
    x_ssm, dt, A, Bm, Cm, z, new_tail = ssm_mixer_inputs(
        p, x, cfg, conv_tail=conv_tail)
    y, state = ssd_chunked(x_ssm, dt, A, Bm, Cm, chunk=chunk,
                           init_state=init_state)
    y = rmsnorm(ssm_gate_input(p, y, x_ssm, z), p["gate_norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_state:
        return out, (state, new_tail)
    return out


def ssm_block_decode(p, x, cfg, state, conv_tail):
    """Single-token decode: the recurrence instead of the chunked form.
    x: (B, 1, d); state (B, H, N, P); conv_tail (B, K-1, conv_dim).
    Returns (out, (new_state, new_tail)), the new state as the recurrence
    leaves it (a float32 decay times the state promotes it to float32);
    the caller stores it in its cache's dtype."""
    x_ssm, dt, A, Bm, Cm, z, new_tail = ssm_mixer_inputs(
        p, x, cfg, conv_tail=conv_tail)
    y, new_state = ssd_recurrent_step(state, x_ssm[:, 0], dt[:, 0], A,
                                      Bm[:, 0], Cm[:, 0])
    y = rmsnorm(ssm_gate_input(p, y[:, None], x_ssm, z), p["gate_norm"],
                cfg.norm_eps)
    return y @ p["out_proj"], (new_state, new_tail)
