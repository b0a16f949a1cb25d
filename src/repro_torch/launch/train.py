"""The decoupled PD-ASGD training step on one device (port of the flat route
of ``repro/launch/train.py``).

The M workers live on one device, stacked on the leading axis of every
plane buffer: the state holds ``{group: (M, n_group)}`` buffers where the
JAX package holds one ``(n_group,)`` shard per mesh device. The step is
assembled from the same three lanes:

* ``forward_lane``: loss and gradients on the READ plane, with an R:1
  forward:backward ratio (only slice 0 gets a backward; the loss averages
  all R slices). Workers run one after the other, each writing its
  gradients straight into its row of a stacked gradient plane.
* ``backward_update_lane``: a D-deep gradient FIFO feeding the optimizer on
  the WRITE plane, with the nonfinite skip and the straggler mask.
* the gossip lanes: the push-sum ring hop is ``torch.roll(buf, s, 0)``, the
  permutation ``i → i+s mod M`` of the reference's ``ppermute``, with the
  shift ``s`` drawn on the host each step. ``gossip_fused_lane`` (the
  ``use_pallas`` route) folds apply and mix into one pass per layer group
  through the ``gossip_mix`` kernel: ``α·x + β·recv + upd``.

Then the read plane adopts the mixed write plane and each group's clock is
stamped ``t + φ_g``. Everything stays on the device: push-sum weights,
α/β, FIFO stamps and metrics are device tensors, and a step makes no host
synchronisation of its own.

A step CONSUMES the state it is given, as the reference's jitted step
donates it (``donate_argnums=(0,)``): the optimizer state, the applied FIFO
slot and, on the fused route, the write plane are updated in place, which
keeps GPT-2 Medium at M=4 within one 80 GB card. Callers keep the returned
state, never the one they passed in.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.convert import to_torch
from repro_torch.core.layerview import (FlatPartition, send_fractions,
                                        stamp_groups, version_metrics)
from repro_torch.core.pytree import tree_flatten, tree_map, tree_unflatten
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import gossip_mix_ref
from repro_torch.optim.optimizers import Optimizer, apply_updates


# ---------------------------------------------------------------------------
# forward lane
# ---------------------------------------------------------------------------


def _split_fwd_slices(batch, R: int):
    """Split a per-worker batch into R equal forward slices along the batch
    dim, dim 0 of every leaf (slice 0 feeds the backward lane)."""
    def slc(x, r):
        n = x.shape[0]
        if n % R:
            raise ValueError(
                f"fb_ratio={R} needs per-worker batch divisible by {R}; "
                f"got leaf shape {tuple(x.shape)}")
        return x[(n // R) * r:(n // R) * (r + 1)]

    return [tree_map(lambda x: slc(x, r), batch) for r in range(R)]


def forward_lane(loss_fn: Callable, *, fb_ratio: int = 1) -> Callable:
    """Forward (+ autograd backward) on one worker's read parameters.

    Returns ``fwd(params, batch) -> (loss, grads)`` with ``loss`` a 0-d
    tensor and ``grads`` a tree like ``params``. With ``fb_ratio=R > 1``
    only slice 0 gets a backward; the other R-1 slices run forward-only
    under ``no_grad`` and the loss averages all R."""
    R = int(fb_ratio)
    if R < 1:
        raise ValueError("fb_ratio must be >= 1")

    def fwd(params, batch):
        leaves, treedef = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        slices = _split_fwd_slices(batch, R) if R > 1 else [batch]
        with torch.enable_grad():
            bwd_loss, _ = loss_fn(tree_unflatten(treedef, leaves), slices[0])
            grads = torch.autograd.grad(bwd_loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        loss = bwd_loss.detach()
        if R > 1:
            with torch.no_grad():
                fwd_losses = [loss_fn(params, s)[0] for s in slices[1:]]
            loss = (loss + sum(fwd_losses)) / R
        return loss, tree_unflatten(treedef, grads)

    return fwd


# ---------------------------------------------------------------------------
# backward/update lane
# ---------------------------------------------------------------------------


def backward_update_lane(optimizer: Optimizer, schedule: Callable, *,
                         update_delay: int = 0, apply: bool = True
                         ) -> Callable:
    """Delayed update application on the stacked write plane.

    Returns ``upd(params, opt_state, grads, fifo, step_idx, active=None) ->
    (params | updates, opt_state, fifo, update_staleness,
    nonfinite_skips)``. With ``update_delay=D > 0`` gradients pass through
    a D-deep FIFO ``{"g": {group: (M, D, n)} in the params' dtypes,
    "stamp": (D,) f32}`` shared by all workers: the gradient applied at
    step ``t`` was made at step ``t − D`` (warm-up: zeros with stamp −1).

    A (worker, group) whose delayed gradient holds a NaN/Inf is skipped:
    its gradient is replaced by zeros with a SELECT before the optimizer
    (never ``g·0``: Inf·0 is NaN) and its update is selected to zero, so
    its parameters stay unchanged. ``nonfinite_skips`` counts the skipped
    (worker, group) pairs. ``active`` ((M,) 0/1 float) masks the update's
    application per worker (the straggler emulation; the optimizer state
    still advances). ``apply=False`` returns the update deltas in place of
    the new params: the contract of :func:`gossip_fused_lane`."""
    D = int(update_delay)
    if D < 0:
        raise ValueError("update_delay must be >= 0")

    def upd(params, opt_state, grads, fifo, step_idx, active=None):
        step_f = float(np.float32(step_idx))
        if D > 0:
            g_apply = {k: b[:, 0] for k, b in fifo["g"].items()}
            applied_stamp = fifo["stamp"][0]
            fifo = {
                # D == 1: the new gradient buffer itself is the FIFO slot
                "g": {k: (grads[k].to(b.dtype)[:, None] if D == 1 else
                          torch.cat([b[:, 1:], grads[k].to(b.dtype)[:, None]],
                                    dim=1))
                      for k, b in fifo["g"].items()},
                "stamp": torch.cat([fifo["stamp"][1:],
                                    fifo["stamp"].new_full((1,), step_f)]),
            }
            grads = {k: g.to(params[k].dtype) for k, g in g_apply.items()}
            update_staleness = torch.where(applied_stamp >= 0.0,
                                           step_f - applied_stamp,
                                           torch.zeros_like(applied_stamp))
        else:
            any_p = next(iter(params.values()))
            update_staleness = torch.zeros((), dtype=torch.float32,
                                           device=any_p.device)
        ok = {k: torch.isfinite(g).all(dim=-1) for k, g in grads.items()}
        skips = sum((~o).sum(dtype=torch.float32) for o in ok.values())
        for k, g in grads.items():  # a select, in the consumed buffer
            g.masked_fill_(~ok[k][:, None], 0.0)
        lr = schedule(step_idx)
        updates, opt_state = optimizer.update(grads, opt_state, params, lr)
        del grads
        for k, u in updates.items():
            u.masked_fill_(~ok[k][:, None], 0.0)
            if active is not None:
                u.mul_(active[:, None].to(u.dtype))
        out = updates if not apply else apply_updates(params, updates)
        return out, opt_state, fifo, update_staleness, skips

    return upd


def fifo_init(plane_single: Dict[str, torch.Tensor], update_delay: int,
              M: int):
    """Zero FIFO state: ``(M, D, n)`` gradient buffers in the plane's dtypes
    plus f32 stamps of −1."""
    D = int(update_delay)
    any_p = next(iter(plane_single.values()))
    return {"g": {k: torch.zeros((M, D) + tuple(p.shape), dtype=p.dtype,
                                 device=p.device)
                  for k, p in plane_single.items()},
            "stamp": torch.full((D,), -1.0, dtype=torch.float32,
                                device=any_p.device)}


# ---------------------------------------------------------------------------
# gossip lanes
# ---------------------------------------------------------------------------


def _ring_exchange(plane, w, shift_idx, shifts: Sequence[int]):
    """One push-sum ring hop on the stacked plane: worker ``i`` sends its
    buffers and half its weight to worker ``i + s mod M``, i.e. row ``j``
    receives row ``j − s`` (``torch.roll(buf, s, 0)``).

    Returns ``(recv, w_keep, rw)``. ``recv`` maps each group to a
    zero-argument function that makes the received buffer, so a caller can
    hold one group's copy at a time."""
    s = int(shifts[int(shift_idx)])
    w_keep = w * 0.5
    rw = torch.roll(w * 0.5, s, 0)
    recv = {name: (lambda v=v: torch.roll(v, s, 0))
            for name, v in plane.items()}
    return recv, w_keep, rw


def gossip_plane_lane(part: FlatPartition, M: int, shifts: Sequence[int]):
    """Push-sum ring gossip on the stacked flat plane, after the update was
    applied: ``(w/2·mine + w'/2·recv) / (w/2 + w'/2)`` in f32, plain
    PyTorch. Returns ``mix(plane, w, shift_idx) -> (plane, w)``; the
    identity when M == 1."""
    if M == 1:
        return lambda plane, w, shift_idx: (plane, w)

    def mix(plane, w, shift_idx):
        recv, w_keep, rw = _ring_exchange(plane, w, shift_idx, shifts)
        new_w = w_keep + rw
        mixed = {}
        for name, mine in plane.items():
            r = recv[name]()
            mf = (w_keep[:, None] * mine.to(torch.float32)
                  + rw[:, None] * r.to(torch.float32)) / new_w[:, None]
            mixed[name] = mf.to(mine.dtype)
            del r
        return mixed, new_w

    return mix


def gossip_fused_lane(part: FlatPartition, M: int, shifts: Sequence[int], *,
                      use_pallas: bool = True):
    """The paper's Alg. 1 ordering, fused: ship the PRE-update plane, then
    one pass per group computes ``mixed = α·x + β·recv + upd`` (3 reads + 1
    write). Returns ``mix_apply(plane, updates, w, shift_idx) -> (plane,
    w)``. At M == 1 it is a fused ``x + upd`` (α=1, β=0), still one pass
    per group.

    ``use_pallas=True`` sends each group through ``ops.gossip_mix`` (the
    Triton kernel on a CUDA tensor); ``False`` calls the plain
    ``gossip_mix_ref`` directly, the same arithmetic in PyTorch ops. The
    result is written into ``plane``'s buffers in place."""
    op = ops.gossip_mix if use_pallas else gossip_mix_ref

    def mix_apply(plane, updates, w, shift_idx):
        if M == 1:
            one, zero = torch.ones_like(w), torch.zeros_like(w)
            mixed = {name: op(x, x, updates[name], one, zero, out=x)
                     for name, x in plane.items()}
            return mixed, w
        recv, w_keep, rw = _ring_exchange(plane, w, shift_idx, shifts)
        new_w = w_keep + rw
        alpha, beta = w_keep / new_w, rw / new_w
        mixed = {}
        for name, x in plane.items():
            r = recv[name]()
            mixed[name] = op(x, r, updates[name], alpha, beta, out=x)
            del r
        return mixed, new_w

    return mix_apply


# ---------------------------------------------------------------------------
# the decoupled step
# ---------------------------------------------------------------------------


def _decoupled_worker_fn(part: FlatPartition, fwd: Callable, upd: Callable,
                         mix: Optional[Callable], M: int, D: int, *,
                         active_fn: Optional[Callable] = None,
                         fused_mix: Optional[Callable] = None):
    """The decoupled step over all M stacked workers:
    ``step(state, batch, step_idx, shift_idx) -> (state, metrics)``.

    Order: forward on the READ plane → delayed update on the WRITE plane →
    gossip (``fused_mix`` folds apply+mix; else apply then ``mix``) → the
    read plane adopts the mixed write plane → each group's clock is stamped
    ``t + φ_g`` (only when M > 1: with one worker nothing is received).
    ``batch`` carries a leading ``(M,)`` worker axis on every leaf."""
    phi = send_fractions(part.num_groups)
    phi_on: Dict[torch.device, torch.Tensor] = {}  # φ copied once per device

    def step(state, batch, step_idx, shift_idx):
        read, write = state["read"], state["write"]
        opt_state, w, versions = state["opt"], state["w"], state["versions"]
        fifo = state.get("fifo", ())
        grads = {k: torch.empty_like(v) for k, v in read.items()}
        losses = []
        for m in range(M):
            loss_m, g_m = fwd(part.unpack({k: v[m] for k, v in read.items()}),
                              {k: v[m] for k, v in batch.items()})
            part.pack(g_m, out={k: v[m] for k, v in grads.items()})
            del g_m
            losses.append(loss_m)
        active = active_fn(step_idx) if active_fn is not None else None
        if fused_mix is not None:
            updates, opt_state, fifo, upd_stale, skips = upd(
                write, opt_state, grads, fifo, step_idx, active=active)
            del grads
            write, w = fused_mix(write, updates, w, shift_idx)
            del updates
        else:
            write, opt_state, fifo, upd_stale, skips = upd(
                write, opt_state, grads, fifo, step_idx, active=active)
            del grads
            write, w = mix(write, w, shift_idx)
        read = write
        if M > 1:
            if versions.device not in phi_on:
                phi_on[versions.device] = torch.from_numpy(phi).to(
                    versions.device)
            stamp = phi_on[versions.device] + float(np.float32(step_idx))
            versions = stamp_groups(versions, stamp)
        loss = torch.stack(losses).mean()
        new_state = {"read": read, "write": write, "opt": opt_state, "w": w,
                     "versions": versions}
        if D > 0:
            new_state["fifo"] = fifo
        return new_state, _decoupled_metrics(w, versions, loss, upd_stale,
                                             step_idx, skips)

    return step


def make_decoupled_state(params_stacked, optimizer: Optimizer, *,
                         update_delay: int = 0,
                         part: Optional[FlatPartition] = None):
    """Initial step state: the params packed ONCE into the stacked plane,
    as two separate copies (read, write), optimizer state in plane layout,
    push-sum weights ``1/M``, zero version clocks and, with D > 0, a zero
    gradient FIFO with stamps −1."""
    leaves, _ = tree_flatten(params_stacked)
    M = leaves[0].shape[0]
    D = int(update_delay)
    if part is None:
        part = FlatPartition(tree_map(lambda x: x[0], params_stacked))
    plane = part.pack(params_stacked)
    read = {k: v.clone(memory_format=torch.contiguous_format)
            for k, v in plane.items()}
    write = {k: v.clone(memory_format=torch.contiguous_format)
             for k, v in plane.items()}
    del plane
    device = leaves[0].device
    state = {
        "read": read,
        "write": write,
        "opt": optimizer.init(read),
        "w": torch.full((M,), 1.0 / M, dtype=torch.float32, device=device),
        "versions": part.init_versions(M, device=device),
    }
    if D > 0:
        state["fifo"] = fifo_init({k: v[0] for k, v in read.items()}, D, M)
    return state


def _decoupled_metrics(w, versions, loss, upd_stale, step_idx, skips):
    out = {"loss": loss, "update_staleness": upd_stale,
           "weight_sum": torch.sum(w), "nonfinite_skips": skips}
    out.update(version_metrics(versions, step_idx))
    return out


def straggler_active_fn(M: int, straggler_delays, device) -> Optional[Callable]:
    """Per-worker 0/1 activity mask: ``straggler_delays[i] = d`` makes
    worker ``i`` active every ``d + 1`` steps. Computed on the device.
    Returns ``None`` when no delays are given."""
    if straggler_delays is None:
        return None
    delays = torch.as_tensor(np.asarray(straggler_delays), dtype=torch.int64,
                             device=device)
    if delays.shape != (M,):
        raise ValueError(f"straggler_delays needs {M} entries")

    def active_fn(step_idx):
        return (torch.remainder(int(step_idx), delays + 1) == 0).to(
            torch.float32)

    return active_fn


def make_decoupled_backend_trainer(loss_fn: Callable, optimizer: Optimizer,
                                   schedule: Callable, M: int, *,
                                   device=None,
                                   shifts: Sequence[int] = (1, 2, 4, 8),
                                   fb_ratio: int = 1, update_delay: int = 0,
                                   straggler_delays=None,
                                   measure_drift: bool = False,
                                   use_pallas: bool = False):
    """Decoupled LayUp over a params dict + ``loss_fn``: the engine behind
    the ``"prod"`` backend. ``M`` workers are stacked on ``device`` (the
    reference takes a mesh with M devices on its worker axis).

    Batches use the sim layout: every leaf carries a leading ``(M,)``
    worker axis. Only the flat plane and ``wire="param"`` are ported; the
    prod backend rejects the other options. ``use_pallas=True`` is the fused Alg. 1 route through the
    ``gossip_mix`` kernel (:func:`gossip_fused_lane`); the default applies
    the update and then mixes in plain PyTorch (:func:`gossip_plane_lane`).

    Returns ``(init_fn, step_fn, shifts, box)`` as the reference does:
    ``init_fn(rng, params_single) -> state``, ``step_fn(state, batch,
    step_idx, shift_idx) -> (state, metrics)``, the effective gossip shift
    set, and ``box["part"]`` (the FlatPartition, after ``init_fn``)."""
    device = resolve_device(device)
    R, D = int(fb_ratio), int(update_delay)
    shifts = tuple(s % M for s in shifts if s % M != 0) or (1,)
    active_fn = straggler_active_fn(M, straggler_delays, device)
    part_box: Dict[str, Any] = {}

    def build(params_single):
        part = FlatPartition(params_single)
        fwd = forward_lane(loss_fn, fb_ratio=R)
        upd = backward_update_lane(optimizer, schedule, update_delay=D,
                                   apply=not use_pallas)
        if use_pallas:
            mix, fused = None, gossip_fused_lane(part, M, shifts)
        else:
            mix, fused = gossip_plane_lane(part, M, shifts), None
        base_step = _decoupled_worker_fn(part, fwd, upd, mix, M, D,
                                         active_fn=active_fn,
                                         fused_mix=fused)

        def step(state, batch, step_idx, shift_idx):
            new_state, metrics = base_step(state, batch, step_idx, shift_idx)
            if measure_drift:
                from repro_torch.core.api import disagreement
                metrics["disagreement"] = disagreement(new_state["read"],
                                                       new_state["w"])
            return new_state, metrics

        return step, part

    def init_fn(rng, params_single):
        del rng
        params_single = to_torch(params_single, device)
        stacked = tree_map(lambda p: p[None].expand((M,) + tuple(p.shape)),
                           params_single)
        if "step" not in part_box:
            part_box["step"], part_box["part"] = build(params_single)
        return make_decoupled_state(stacked, optimizer, update_delay=D,
                                    part=part_box["part"])

    def step_fn(state, batch, step_idx, shift_idx):
        if "step" not in part_box:
            raise RuntimeError("call init_fn before step_fn")
        batch = to_torch(batch, device)
        with torch.no_grad():
            return part_box["step"](state, batch, int(step_idx),
                                    int(shift_idx))

    return init_fn, step_fn, shifts, part_box
