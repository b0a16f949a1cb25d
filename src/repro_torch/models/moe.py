"""Mixture-of-Experts layer: top-k router + capacity-based dispatch (port of
``repro/models/moe.py``).

Each assignment (token t, choice j), taken token-major, gets the rank of
its expert among the assignments before it; ranks below the capacity C are
kept, each owning its slot (expert, rank) of an (E, C, d) buffer, and the
rest drop (switch-style). Dispatch and combine are written without
floating-point atomics, so that two runs give the same bits on a GPU:

- dispatch writes each kept assignment's token row to its own slot
  (``index_put_`` without accumulation); dropped ones go to a discard row
  past the buffer. A token's k copies are an ``expand``, whose backward is
  a sum over k, where a gather ``x[tok_idx]`` would scatter-add;
- combine writes each slot's output row back to the assignment that owns
  it (the same kind of write, empty slots to a discard row), so its
  backward is a gather where the reference's ``out_buf[e, s]`` would
  scatter-add; a token's k weighted rows are then summed in the order
  0..k-1, each sum rounded to the model's dtype as the reference's
  scatter-add rounds after each add.

Experts are chosen by a stable descending sort of the router's
probabilities: among equal values the lower expert index comes first, as
``jax.lax.top_k`` orders them (``torch.topk`` promises no order).

``groups=G`` is the reference's grouped dispatch (its module-level
``GROUPS``): the tokens split into G groups, each with capacity
``capacity(T/G, ...)`` and its own ranks, so drops differ from G=1. The
reference's sharding constraints (``_wsc``, ``GROUP_PSPEC``,
``EXPERT_PSPEC``) have no meaning on one device and are not ported.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec


def moe_specs(cfg, prefix_layers: Tuple[int, ...] = ()):
    d, E, Fd = cfg.d_model, cfg.num_experts, cfg.expert_d_ff()
    L = tuple(prefix_layers)
    La = tuple("layers" for _ in L)
    return {
        "router": ParamSpec(L + (d, E), La + ("embed", None), scale=0.02),
        "wi_gate": ParamSpec(L + (E, d, Fd), La + ("experts", "embed", "ffn")),
        "wi_up": ParamSpec(L + (E, d, Fd), La + ("experts", "embed", "ffn")),
        "wo": ParamSpec(L + (E, Fd, d), La + ("experts", "ffn", "embed"),
                        init="scaled",
                        scale=0.02 / np.sqrt(max(2 * cfg.num_layers, 1))),
    }


def capacity(tokens: int, num_experts: int, k: int, factor: float) -> int:
    c = int(math.ceil(tokens * k / num_experts * factor))
    return max(c, k)  # at least k slots so tiny smoke shapes work


class DispatchMeta(NamedTuple):
    """What combine needs of one group's dispatch. ``slot``: (Tg·k,) the
    flat slot ``e·C + rank`` of each assignment, E·C if dropped;
    ``owner``: (E·C,) the assignment that fills each slot, Tg·k if
    empty; ``keep``: (Tg·k,) bool; ``gate_vals``: (Tg, k) float32
    renormalised gates; ``gate_idx``: (Tg, k) experts, best first."""

    slot: torch.Tensor
    owner: torch.Tensor
    keep: torch.Tensor
    gate_vals: torch.Tensor
    gate_idx: torch.Tensor


def _route(xt, router, k):
    """Router probabilities (T, E) float32 and the top-k (values, experts),
    ties to the lower expert index."""
    logits = (xt @ router).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, vals[:, :k], idx[:, :k]


def _dispatch_group(xt, p, cfg, C):
    """Top-k dispatch of one token group. xt: (Tg, d).
    Returns (buf (E, C, d), DispatchMeta, router probs (Tg, E))."""
    Tg, d = xt.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    probs, gate_vals, gate_idx = _route(xt, p["router"], k)
    # renormalize the chosen gates (mixtral-style)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # capacity slots: rank of each assignment within its expert, over the
    # assignments token-major (a token's first choice before its second)
    flat_e = gate_idx.reshape(-1)  # (Tg*k,)
    onehot = F.one_hot(flat_e, E)
    ranks = torch.cumsum(onehot, dim=0) - onehot
    rank = torch.gather(ranks, 1, flat_e[:, None])[:, 0]
    keep = rank < C
    n = E * C
    slot = torch.where(keep, flat_e * C + rank, n)
    assignments = torch.arange(Tg * k, device=xt.device)
    owner = torch.full((n + 1,), Tg * k, dtype=torch.long,
                       device=xt.device).index_put_((slot,), assignments)[:n]
    copies = xt[:, None, :].expand(Tg, k, d).reshape(Tg * k, d)
    buf = xt.new_zeros(n + 1, d).index_put_((slot,), copies)
    meta = DispatchMeta(slot, owner, keep, gate_vals, gate_idx)
    return buf[:n].view(E, C, d), meta, probs


def _combine_group(out_buf, meta, Tg, d, dtype):
    """Each token's kept expert outputs, weighted by its gates and summed
    in choice order. out_buf: (E, C, d) → (Tg, d)."""
    k = meta.gate_idx.shape[1]
    rows = out_buf.new_zeros(Tg * k + 1, d).index_put_(
        (meta.owner,), out_buf.reshape(-1, d))[:Tg * k]
    w = torch.where(meta.keep, meta.gate_vals.reshape(-1), 0.0).to(dtype)
    contrib = (rows * w[:, None]).view(Tg, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


def _expert_ffn(p, buf):
    h = F.silu(torch.bmm(buf, p["wi_gate"])) * torch.bmm(buf, p["wi_up"])
    return torch.bmm(h, p["wo"])  # (E, C, d)


def moe_apply(p, x, cfg, *, return_aux=True, groups=1):
    """x: (B, S, d) → (B, S, d), aux load-balance loss (float32 scalar).

    Top-k routing with per-expert capacity; overflow drops. With
    ``groups`` > 1 (and dividing B·S) each of the token groups has its own
    capacity and ranks, the reference's grouped dispatch.
    """
    B, S, d = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.experts_per_token
    G = groups if T % groups == 0 else 1
    xt = x.reshape(T, d)

    if G == 1:
        C = capacity(T, E, k, cfg.capacity_factor)
        buf, meta, probs = _dispatch_group(xt, p, cfg, C)
        y = _combine_group(_expert_ffn(p, buf), meta, T, d, x.dtype)
        gate_idx = meta.gate_idx
    else:
        Tg = T // G
        Cg = capacity(Tg, E, k, cfg.capacity_factor)
        parts = [_dispatch_group(xg, p, cfg, Cg) for xg in xt.view(G, Tg, d)]
        # (G, E, Cg, d) group-major → (E, G·Cg, d) expert-major and back
        ebuf = torch.stack([b for b, _, _ in parts], 1).reshape(
            E, G * Cg, d)
        out = _expert_ffn(p, ebuf).view(E, G, Cg, d)
        y = torch.cat([_combine_group(out[:, g], m, Tg, d, x.dtype)
                       for g, (_, m, _) in enumerate(parts)])
        probs = torch.cat([pr for _, _, pr in parts])
        gate_idx = torch.cat([m.gate_idx for _, m, _ in parts])
    y = y.reshape(B, S, d)

    if not return_aux:
        return y, torch.zeros((), dtype=torch.float32, device=x.device)
    # Switch/Mixtral load-balance aux: E * sum_e f_e * P_e
    f = F.one_hot(gate_idx, E).sum(1).to(torch.float32).mean(0)
    P = probs.mean(0)
    aux = E * torch.sum(f / k * P)
    return y, aux


def moe_apply_dense(p, x, cfg):
    """Oracle: dense dispatch (every expert sees every token). O(T·E)
    compute; only for tests on tiny shapes."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.experts_per_token
    xt = x.reshape(T, d)
    _, gate_vals, gate_idx = _route(xt, p["router"], k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    h = F.silu(torch.einsum("td,edf->etf", xt, p["wi_gate"])) * \
        torch.einsum("td,edf->etf", xt, p["wi_up"])
    full = torch.einsum("etf,efd->etd", h, p["wo"])
    mask = F.one_hot(gate_idx, E).to(torch.float32)  # (T, k, E)
    w = torch.einsum("tke,tk->te", mask, gate_vals).to(x.dtype)  # (T, E)
    y = torch.einsum("etd,te->td", full, w)
    return y.reshape(B, S, d)
