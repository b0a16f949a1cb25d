"""Plain PyTorch forward passes and losses of the benchmark's models, in
float32, written from the architectures' published descriptions.

Parameters are a flat dict ``{"blocks/sub0/attn/wq": tensor, ...}`` of
float32 tensors; layers are stacked on the leading axis of each
``blocks/...`` leaf. Every matrix product goes through ``mm``
(``precision.rounder``): no rounding for the reference, TF32 or FP8
operands and gradients for the low-precision controls. Attention is written out (scores,
causal mask, softmax); the SSD is the chunked dual form of arXiv:2405.21060,
Listing 1. Nothing here imports the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32


def rmsnorm(x, gamma, eps):
    var = (x * x).mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * gamma


def einsum(mm, spec, *ops):
    return mm.result(torch.einsum(spec, *(mm.operand(o) for o in ops)))


def cross_entropy(logits, labels):
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (lse - gold).mean()


def layer(p, prefix, i):
    """Layer ``i``'s parameters under ``prefix`` (views of the stacks)."""
    return {k[len(prefix):]: v[i] for k, v in p.items()
            if k.startswith(prefix)}


def rotary(x, theta):
    """Rotary positions on (B, S, H, D), the two halves of each head
    rotated as a pair (GPT-NeoX layout), positions 0 .. S-1."""
    S, D = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64) / D)
    ang = (torch.arange(S, dtype=torch.float64)[:, None] * inv).to(
        device=x.device, dtype=F32)
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(a, x, cfg, mm):
    """Causal softmax attention of one pre-normed sub-layer input."""
    q = einsum(mm, "bsd,dhk->bshk", x, a["wq"])
    k = einsum(mm, "bsd,dhk->bshk", x, a["wk"])
    v = einsum(mm, "bsd,dhk->bshk", x, a["wv"])
    q, k = rotary(q, cfg["rope_theta"]), rotary(k, cfg["rope_theta"])
    S, D = x.shape[1], q.shape[-1]
    s = einsum(mm, "bqhd,bkhd->bhqk", q * D ** -0.5, k)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = einsum(mm, "bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return einsum(mm, "bshk,hkd->bsd", o, a["wo"])


def gated_mlp(f, x, mm):
    g = einsum(mm, "bsd,df->bsf", x, f["wi_gate"])
    u = einsum(mm, "bsd,df->bsf", x, f["wi_up"])
    return einsum(mm, "bsf,fd->bsd", F.silu(g) * u, f["wo"])


def layers(block, p, prefix, h, cfg, mm):
    """``block`` over every layer in turn. Under autograd each layer keeps
    only its input and is recomputed in the backward pass (the same
    arithmetic again), so that the reference fits beside its state."""
    for i in range(cfg["num_layers"]):
        lp = layer(p, prefix, i)
        if torch.is_grad_enabled():
            h = checkpoint(block, lp, h, cfg, mm, use_reentrant=False)
        else:
            h = block(lp, h, cfg, mm)
    return h


def decoder_block(lp, h, cfg, mm):
    """Pre-norm decoder block: attention then gated MLP, each with its
    residual."""
    eps = cfg["norm_eps"]
    a = {k[5:]: v for k, v in lp.items() if k.startswith("attn/")}
    f = {k[4:]: v for k, v in lp.items() if k.startswith("mlp/")}
    h = h + attention(a, rmsnorm(h, a["norm"], eps), cfg, mm)
    return h + gated_mlp(f, rmsnorm(h, f["norm"], eps), mm)


def decoder_hidden(p, h, cfg, mm):
    return layers(decoder_block, p, "blocks/sub0/", h, cfg, mm)


def segsum(x):
    """(..., T) → (..., T, T): sum of x over (j, i] below the diagonal,
    -inf above it."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    below = torch.ones(T, T, dtype=torch.bool, device=x.device).tril(-1)
    out = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    keep = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~keep, float("-inf"))


def ssd(x, dt, A, Bm, Cm, mm, chunk):
    """y of the SSM recurrence h_t = exp(dt_t·A)·h_{t-1} + dt_t·B_t ⊗ x_t,
    y_t = C_t·h_t, in its chunked dual form. x (b, l, h, p), dt (b, l, h),
    A (h,), Bm/Cm (b, l, n), shared over heads."""
    b, l, h, p = x.shape
    c = l // chunk
    X = (x * dt[..., None]).reshape(b, c, chunk, h, p)
    Ad = (dt * A).reshape(b, c, chunk, h).permute(0, 3, 1, 2)  # b h c q
    Bc = Bm.reshape(b, c, chunk, -1)
    Cc = Cm.reshape(b, c, chunk, -1)
    A_cum = torch.cumsum(Ad, dim=-1)
    Lmat = torch.exp(segsum(Ad))                              # b h c q s
    CB = einsum(mm, "bcqn,bcsn->bcqs", Cc, Bc)
    y_diag = einsum(mm, "bhcqs,bcshp->bcqhp", CB[:, None] * Lmat, X)
    decay = torch.exp(A_cum[..., -1:] - A_cum)                # b h c q
    states = einsum(mm, "bcqn,bhcq,bcqhp->bchpn", Bc, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(A_cum[..., -1], (1, 0))))
    states = einsum(mm, "bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y_off = einsum(mm, "bcqn,bchpn,bhcq->bcqhp", Cc, states,
                   torch.exp(A_cum))
    return (y_diag + y_off).reshape(b, l, h, p)


def causal_conv(xbc, w, bias):
    """Depthwise causal convolution of width K over (B, S, C)."""
    K, S = w.shape[0], xbc.shape[1]
    full = F.pad(xbc, (0, 0, K - 1, 0))
    return sum(full[:, i:i + S] * w[i] for i in range(K)) + bias


def mamba2_block(s, h, cfg, mm):
    """Mamba2 block (arXiv:2405.21060): pre-norm, input projections, causal
    conv, SSD with D skip, gated RMSNorm, output projection, residual."""
    eps = cfg["norm_eps"]
    di = cfg["ssm_expand"] * cfg["d_model"]
    n, hp = cfg["ssm_state"], cfg["ssm_head_dim"]
    x = rmsnorm(h, s["norm"], eps)
    z = einsum(mm, "bsd,de->bse", x, s["in_proj_z"])
    xbc = torch.cat([einsum(mm, "bsd,de->bse", x, s[k]) for k in
                     ("in_proj_x", "in_proj_B", "in_proj_C")], dim=-1)
    dt = F.softplus(einsum(mm, "bsd,de->bse", x, s["in_proj_dt"])
                    + s["dt_bias"])
    xbc = F.silu(causal_conv(xbc, s["conv_w"], s["conv_b"]))
    B_, S = x.shape[:2]
    xs = xbc[..., :di].reshape(B_, S, di // hp, hp)
    y = ssd(xs, dt, -torch.exp(s["A_log"]), xbc[..., di:di + n],
            xbc[..., di + n:], mm, cfg["ssd_chunk"])
    y = (y + s["D"][:, None] * xs).reshape(B_, S, di) * F.silu(z)
    y = rmsnorm(y, s["gate_norm"], eps)
    return h + einsum(mm, "bse,ed->bsd", y, s["out_proj"])


def mamba2_hidden(p, h, cfg, mm):
    return layers(mamba2_block, p, "blocks/sub0/ssm/", h, cfg, mm)


HIDDEN = {"dense": decoder_hidden, "ssm": mamba2_hidden}


def loss(p, batch, cfg, mm):
    """Mean next-token cross entropy of a batch {"tokens", "labels"} (B, S),
    with the unembedding tied to the token embedding."""
    h = p["embed/tok"][batch["tokens"]]
    h = HIDDEN[cfg["family"]](p, h, cfg, mm)
    h = rmsnorm(h, p["final_norm"], cfg["norm_eps"])
    logits = einsum(mm, "bsd,vd->bsv", h, p["embed/tok"])
    return cross_entropy(logits, batch["labels"])


def check_config(cfg):
    """The reference covers the decoder and Mamba2 families as specified;
    anything else is refused rather than silently mis-modelled."""
    if cfg["family"] not in HIDDEN:
        raise ValueError(f"no reference for family {cfg['family']!r}")
    plain = (cfg.get("tie_embeddings", True)
             and math.isclose(cfg.get("rope_fraction", 1.0), 1.0)
             and not cfg.get("sliding_window", 0)
             and not cfg.get("qk_norm", False)
             and cfg.get("num_kv_heads") == cfg.get("num_heads"))
    if not plain:
        raise ValueError("the reference models tied embeddings, whole-head "
                         "rotary positions and full multi-head attention")
