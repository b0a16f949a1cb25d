"""The PD-ASGD training steps (port of ``repro/launch/train.py``).

The M workers are stacked on the leading axis of every plane buffer: the
state holds ``{group: (M, n_group)}`` buffers where the JAX package holds
one ``(n_group,)`` shard per mesh device. On a :class:`~repro_torch.launch.
mesh.WorkerMesh` with a process group, each rank holds the ``(L, n_group)``
rows of its ``L = M // world`` workers on its own device, and the ring hop,
the loss mean, the skip count and the drift cross ranks; the ``(M,)``
push-sum weights, the ``(M, G)`` version clocks and the straggler mask
depend on the host-drawn shifts and the step only, so every rank keeps
them whole. The step is assembled from the same three lanes:

* ``forward_lane``: loss and gradients on the READ plane, with an R:1
  forward:backward ratio (only slice 0 gets a backward; the loss averages
  all R slices). Workers run one after the other, each writing its
  gradients straight into its row of a stacked gradient plane.
* ``backward_update_lane``: a D-deep gradient FIFO feeding the optimizer on
  the WRITE plane, with the nonfinite skip and the straggler mask.
* the gossip lanes: the push-sum ring hop is ``torch.roll(buf, s, 0)`` on
  one process and :meth:`WorkerMesh.ring_hop` across ranks, the
  permutation ``i → i+s mod M`` of the reference's ``ppermute``, with the
  shift ``s`` drawn on the host each step. ``gossip_fused_lane`` (the
  ``use_pallas`` route) folds apply and mix into one pass per layer group
  through the ``gossip_mix`` kernel: ``α·x + β·recv + upd``.

``wire="int8"`` ships each group as int8 with one f32 scale per 128-element
row, quantizing ``x + resid`` and carrying the error forward in a residual
plane (``state["resid"]``); the fused route runs ``quantize_plane`` and
``dequant_mix`` per group. ``compensate=λ > 0`` corrects the delayed
gradient by ``g + λ·g⊙g⊙(s·(θ − θ_prev))`` with ``θ_prev`` one more plane
(``state["theta"]``, the previous step's pre-update write plane) and ``s``
the measured staleness (DESIGN.md §14).

Then the read plane adopts the mixed write plane and each group's clock is
stamped ``t + φ_g``.

Membership (``faults=``, DESIGN.md §15) adds ``state["alive"]``, the chaos
controller's host mask. While every peer is alive the step is the
fault-free one, bit for bit; while a peer is dead it is alive-gated
(:func:`_ring_exchange`, :func:`gate_update`, :func:`stamp_live`,
:func:`live_loss`).

The pipeline and stream engines (``repro_torch.launch.pipeline``,
``.streams``) run the same lanes split into stages
(``forward_slice_lane`` is one forward slice). Everything stays on the
device: push-sum weights, α/β, FIFO stamps and metrics are device tensors
(``peers_live``, counted from the host mask, is a host one), and a step
makes no host synchronisation of its own.

A step CONSUMES the state it is given, as the reference's jitted step
donates it (``donate_argnums=(0,)``): the optimizer state, the applied FIFO
slot and, on the fused route, the write plane are updated in place, which
keeps GPT-2 Medium at M=4 within one 80 GB card. Callers keep the returned
state, never the one they passed in.

The Model-level factories (``make_step`` and the builders it routes to)
build a :class:`ProdStep` from a ``Model``, a :class:`~repro_torch.launch.
mesh.WorkerMesh` and a ``ShapeConfig``: DDP (one replica over the global
batch), lockstep LayUp (``accum_steps``, the tree-level ``gossip_lane``),
the decoupled step (``make_layup_decoupled_train_step``; ``overlap=True``
routes to the pipeline engines), prefill and decode. Their steps take the
global batch and split it over the workers along each leaf's batch dim.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig, input_specs
from repro_torch.convert import to_torch
from repro_torch.core.layerview import (FlatPartition, LayerPartition,
                                        send_fractions, stamp_groups,
                                        version_metrics)
from repro_torch.core.pytree import (tree_flatten, tree_leaves, tree_map,
                                     tree_unflatten)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (dequant_mix_ref, gossip_mix_ref,
                                     quantize_plane_ref)
from repro_torch.launch.mesh import WorkerMesh
from repro_torch.launch.timeline import span
from repro_torch.optim.optimizers import Optimizer, apply_updates


# ---------------------------------------------------------------------------
# forward lane
# ---------------------------------------------------------------------------


def _batch_dim(leaf) -> int:
    """A leaf's batch dimension: M-RoPE positions, (3, B, S) int32, on dim
    1; every other leaf leads with it (the reference's rule)."""
    if leaf.dim() == 3 and leaf.shape[0] == 3 and leaf.dtype == torch.int32:
        return 1
    return 0


def _split_fwd_slices(batch, R: int, what: str = "fb_ratio"):
    """Split a per-worker batch into R equal forward slices along each
    leaf's batch dim (:func:`_batch_dim`; slice 0 feeds the backward
    lane). ``what`` names the knob in the error (``accum_steps`` cuts
    microbatches the same way)."""
    def slc(x, r):
        d = _batch_dim(x)
        n = x.shape[d]
        if n % R:
            raise ValueError(
                f"{what}={R} needs per-worker batch divisible by {R}; "
                f"got leaf shape {tuple(x.shape)}")
        return x.narrow(d, (n // R) * r, n // R)

    return [tree_map(lambda x: slc(x, r), batch) for r in range(R)]


def forward_slice_lane(loss_fn: Callable, *, fb_ratio: int = 1,
                       slice_idx: int = 0) -> Callable:
    """ONE forward slice of the forward lane, the unit the pipeline engine
    (``repro_torch.launch.pipeline``) runs as a stage of its own.

    Returns ``fwd(params, batch, worker=None)``: slice 0, the backward
    slice, gives ``(loss, grads)`` (autograd under ``enable_grad``); slices
    ``1..R-1`` give ``(loss, None)``, forward only under ``no_grad``. The
    slice is cut by :func:`_split_fwd_slices`, as in :func:`forward_lane`,
    which is built from these lanes. The forward runs in a ``fwd`` lane
    span and the backward in a ``bwd`` one (``repro_torch.launch.
    timeline``), both tagged with ``worker``."""
    R, r = int(fb_ratio), int(slice_idx)
    if R < 1:
        raise ValueError("fb_ratio must be >= 1")
    if not 0 <= r < R:
        raise ValueError(f"slice_idx={r} out of range for fb_ratio={R}")

    def fwd(params, batch, worker=None):
        s = _split_fwd_slices(batch, R)[r] if R > 1 else batch
        if r > 0:
            with torch.no_grad(), span("fwd", worker=worker, slice=r,
                                       work=s):
                return loss_fn(params, s)[0], None
        leaves, treedef = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            with span("fwd", worker=worker, slice=0, work=s):
                loss, _ = loss_fn(tree_unflatten(treedef, leaves), s)
            with span("bwd", worker=worker, slice=0, work=s):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g
                         for g, p in zip(grads, leaves)]
        return loss.detach(), tree_unflatten(treedef, grads)

    return fwd


def combine_slice_losses(loss0, rest: Sequence, R: int):
    """One worker's loss from its R slices: ``(l0 + sum(rest)) / R``, the
    order the reference's lanes use; slice 0's own loss at R == 1."""
    return (loss0 + sum(rest)) / R if R > 1 else loss0


def forward_lane(loss_fn: Callable, *, fb_ratio: int = 1,
                 accum_steps: int = 1) -> Callable:
    """Forward (+ autograd backward) on one worker's read parameters.

    Returns ``fwd(params, batch, worker=None) -> (loss, grads)`` with
    ``loss`` a 0-d tensor and ``grads`` a tree like ``params`` (``worker``
    tags the lane spans). With ``fb_ratio=R > 1``
    only slice 0 gets a backward; the other R-1 slices run forward-only
    under ``no_grad`` and the loss averages all R.

    ``accum_steps=A > 1`` runs the batch as A equal microbatches (cut along
    each leaf's batch dim), one forward and backward each, so the
    activations are a microbatch's: the losses and gradients are summed in
    float32, then ``loss / A`` and the gradients ``/ A`` cast to each
    parameter's dtype. It does not compose with R > 1."""
    R, A = int(fb_ratio), int(accum_steps)
    if R < 1:
        raise ValueError("fb_ratio must be >= 1")
    if A < 1:
        raise ValueError("accum_steps must be >= 1")
    if R > 1 and A > 1:
        raise ValueError("fb_ratio > 1 does not compose with accum_steps")
    lanes = [forward_slice_lane(loss_fn, fb_ratio=R, slice_idx=r)
             for r in range(R)]

    if A > 1:
        def fwd_accum(params, batch, worker=None):
            loss, acc = None, None
            for mb in _split_fwd_slices(batch, A, "accum_steps"):
                l_mb, g_mb = lanes[0](params, mb, worker=worker)
                g_mb, treedef = tree_flatten(g_mb)
                if acc is None:  # 0 + x is x: the first terms start the sums
                    loss = l_mb.to(torch.float32)
                    acc = [g.to(torch.float32) for g in g_mb]
                else:
                    loss = loss + l_mb.to(torch.float32)
                    for a, g in zip(acc, g_mb):
                        a.add_(g.to(torch.float32))
                del g_mb
            grads = [(a / A).to(p.dtype)
                     for a, p in zip(acc, tree_leaves(params))]
            return loss / A, tree_unflatten(treedef, grads)

        return fwd_accum

    def fwd(params, batch, worker=None):
        loss, grads = lanes[0](params, batch, worker=worker)
        rest = [lane(params, batch, worker=worker)[0] for lane in lanes[1:]]
        return combine_slice_losses(loss, rest, R), grads

    return fwd


# ---------------------------------------------------------------------------
# backward/update lane
# ---------------------------------------------------------------------------


# elements of a worker row that the delay compensation corrects at a time:
# its f32 temporaries stay at M × 64 MB instead of whole-group planes
_COMPENSATE_CHUNK = 1 << 24


def _compensate_(g, p, theta, drift, lam: float) -> None:
    """``g ← g + λ·g⊙g⊙(drift·(p − θ))`` in f32, in the gradient buffer
    ``g`` itself, in the reference's order of operations
    (``gf + ((λ·gf)·gf)·delta``); then ``θ ← p``, the pre-update plane the
    next step compares against. Chunked along the group so that no
    plane-sized f32 temporary is made."""
    n = g.shape[-1]
    for lo in range(0, n, _COMPENSATE_CHUNK):
        sl = slice(lo, lo + _COMPENSATE_CHUNK)
        gc, pc, tc = g[..., sl], p[..., sl], theta[..., sl]
        gf = gc.to(torch.float32)
        delta = pc.to(torch.float32) - tc.to(torch.float32)
        delta.mul_(drift)
        corr = gf * lam
        corr.mul_(gf).mul_(delta)
        del delta
        if gc.dtype == torch.float32:
            gc.add_(corr)
        else:
            gc.copy_(gf + corr)
        tc.copy_(pc)


def backward_update_lane(optimizer: Optimizer, schedule: Callable, *,
                         update_delay: int = 0, apply: bool = True,
                         compensate: float = 0.0) -> Callable:
    """Delayed update application on the stacked write plane (any dict of
    ``(M, ...)`` buffers: the plane's groups, or a tree's leaves).

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
    the new params: the contract of :func:`gossip_fused_lane`.

    ``compensate=λ > 0`` corrects the delayed gradient after the nonfinite
    select and before the optimizer: ``g + λ·g⊙g⊙(s·(params − theta))``,
    ``s`` the update staleness and ``theta`` (a kwarg) the previous step's
    pre-update params. The lane then writes this step's pre-update params
    into ``theta`` and appends it (``theta_new``) after
    ``nonfinite_skips``. At D == 0 the staleness is 0 and the correction
    adds zeros."""
    D = int(update_delay)
    if D < 0:
        raise ValueError("update_delay must be >= 0")
    lam = float(compensate)
    if lam < 0:
        raise ValueError("compensate (λ) must be >= 0")

    def upd(params, opt_state, grads, fifo, step_idx, active=None,
            theta=None):
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
        # one verdict per (worker, buffer): a group of the plane, or a leaf
        # of the lockstep and DDP steps' trees
        ok = {k: torch.isfinite(g).reshape(g.shape[0], -1).all(dim=-1)
              for k, g in grads.items()}
        skips = sum((~o).sum(dtype=torch.float32) for o in ok.values())
        for k, g in grads.items():  # a select, in the consumed buffer
            g.masked_fill_(~_rows_mask(ok[k], g), 0.0)
        if lam > 0.0:
            for k, g in grads.items():
                _compensate_(g, params[k], theta[k], update_staleness, lam)
        lr = schedule(step_idx)
        updates, opt_state = optimizer.update(grads, opt_state, params, lr)
        del grads
        for k, u in updates.items():
            u.masked_fill_(~_rows_mask(ok[k], u), 0.0)
            if active is not None:
                u.mul_(_rows_mask(active, u).to(u.dtype))
        out = updates if not apply else apply_updates(params, updates)
        if lam > 0.0:
            return out, opt_state, fifo, update_staleness, skips, theta
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


def _ring_exchange(w, shift_idx, shifts: Sequence[int], alive=None,
                   mesh: Optional[WorkerMesh] = None):
    """One push-sum ring hop on the stacked plane: worker ``i`` sends its
    buffers and half its weight to worker ``i + s mod M``, i.e. row ``j``
    receives row ``j − s`` (``torch.roll(buf, s, 0)``; across the ranks of
    ``mesh``'s group, :meth:`WorkerMesh.ring_hop` on the rank's rows).

    Returns ``(hop, w_keep, rw, use)``. ``hop(buf)`` makes the received copy
    of one stacked buffer, so a caller holds one group's copy at a time, and
    every buffer of a round (an int8 group's q and its scales) moves by the
    same shift. The weights and ``use`` are over all M workers: the lanes
    take the rank's rows of them (:meth:`WorkerMesh.local`).

    ``alive`` (an ``(M,)`` 0/1 float32 device mask, DESIGN.md §15) gates
    the exchange for fault-tolerant membership: mass is sent only when
    both endpoints are alive (``w_sent = w/2 · a_self · a_tgt``: a dead
    target would absorb it, leaking Σw out of the live set; a dead sender
    must not inject its stale plane), so Σw over the live peers is
    conserved exactly every round. ``use`` (bool ``(M,)``, ``None``
    without ``alive``) is true only where both a row and its hop's source
    are alive; a row where it is false must not read what it received.
    With every peer alive the gated weights are the ungated ones bit for
    bit (``w − w/2 == w/2``)."""
    s = int(shifts[int(shift_idx)])
    if mesh is None:
        hop = lambda buf: torch.roll(buf, s, 0)  # noqa: E731
    else:
        hop = lambda buf: mesh.ring_hop(buf, s)  # noqa: E731
    if alive is None:
        return hop, w * 0.5, torch.roll(w * 0.5, s, 0), None
    a_tgt = torch.roll(alive, -s, 0)
    w_sent = w * 0.5 * (alive * a_tgt)
    w_keep = w - w_sent
    use = (torch.roll(alive, s, 0) * alive) > 0.0
    return hop, w_keep, torch.roll(w_sent, s, 0), use


def _mix_weights(w_keep, rw, use):
    """``(new_w, denom, α, β)`` of a hop: ``new_w = w_keep + rw``,
    ``α = w_keep/denom``, ``β = rw/denom``. On a gated hop (``use`` not
    None) a dead peer's weight is 0 on both sides, so ``denom`` guards the
    0/0 with 1 (its buffers are never read again)."""
    new_w = w_keep + rw
    denom = new_w if use is None else torch.where(
        new_w > 0.0, new_w, torch.ones_like(new_w))
    return new_w, denom, w_keep / denom, rw / denom


def _rows_mask(use, x):
    """``use`` shaped to broadcast over the rows of a stacked buffer."""
    return use.reshape((-1,) + (1,) * (x.dim() - 1))


def _check_wire(wire: str, compensate: float) -> None:
    """Validation of the quantized-wire and delay-compensation knobs."""
    if wire not in ("param", "int8"):
        raise ValueError(f"unknown wire dtype {wire!r} "
                         "(expected 'param' or 'int8')")
    if float(compensate) < 0.0:
        raise ValueError("compensate (λ) must be >= 0")


def _local_fn(mesh: Optional[WorkerMesh]) -> Callable:
    """The rank's rows of an ``(M, ...)`` tensor (the identity on one
    process); ``None`` passes through."""
    if mesh is None or mesh.group is None:
        return lambda t: t
    return lambda t: None if t is None else mesh.local(t)


def gossip_plane_lane(part: FlatPartition, M: int, shifts: Sequence[int], *,
                      use_pallas: bool = False, wire: str = "param",
                      mesh: Optional[WorkerMesh] = None):
    """Push-sum ring gossip on the stacked flat plane, after the update was
    applied: ``(w/2·mine + w'/2·recv) / (w/2 + w'/2)`` in f32, plain
    PyTorch. Returns ``mix(plane, w, shift_idx) -> (plane, w)``; the
    identity when M == 1.

    ``use_pallas=True`` sends each group through the pure variant of the
    ``gossip_mix`` kernel (``ops.gossip_mix(mine, recv, None, α, β)``, the
    update already applied): a fresh mixed buffer per group.

    ``wire="int8"`` quantizes each outgoing group with its error-feedback
    residual and mixes the received ``{q, scales}`` with
    ``α·mine + β·(q·s)``, ``α = w_keep/w'``, ``β = rw/w'`` (the plain
    ``quantize_plane_ref`` and ``dequant_mix_ref``). The signature becomes
    ``mix(plane, resid, w, shift_idx) -> (plane, resid, w)``; the residual
    is updated in place. At M == 1 it is the identity: nothing crosses the
    wire, nothing is quantized.

    ``alive=`` (a device mask, see :func:`_ring_exchange`) gates the hop:
    a row whose source or self is dead keeps its own buffer (a select, so
    nothing it received is read).

    ``mesh`` (a :class:`WorkerMesh` with a process group) runs the lane on
    the rank's ``(L, n)`` rows: the hop crosses ranks, the ``(M,)`` weights
    stay whole and each row mixes with its own."""
    _check_wire(wire, 0.0)
    loc = _local_fn(mesh)
    if wire == "int8":
        if M == 1:
            return lambda plane, resid, w, shift_idx, alive=None: (
                plane, resid, w)

        def mix_q(plane, resid, w, shift_idx, alive=None):
            hop, w_keep, rw, use = _ring_exchange(w, shift_idx, shifts,
                                                  alive, mesh)
            new_w, _, alpha, beta = _mix_weights(w_keep, rw, use)
            alpha, beta, use = loc(alpha), loc(beta), loc(use)
            mixed = {}
            for name, mine in plane.items():
                q, s, _ = quantize_plane_ref(mine, resid[name],
                                             out_resid=resid[name])
                mx = dequant_mix_ref(mine, hop(q), hop(s), None, alpha, beta)
                del q, s
                mixed[name] = mx if use is None else torch.where(
                    _rows_mask(use, mine), mx, mine)
            return mixed, resid, new_w

        return mix_q
    if M == 1:
        return lambda plane, w, shift_idx, alive=None: (plane, w)

    def mix(plane, w, shift_idx, alive=None):
        hop, w_keep, rw, use = _ring_exchange(w, shift_idx, shifts, alive,
                                              mesh)
        new_w, denom, alpha, beta = _mix_weights(w_keep, rw, use)
        w_keep, rw, denom = loc(w_keep), loc(rw), loc(denom)
        alpha, beta, use = loc(alpha), loc(beta), loc(use)
        mixed = {}
        for name, mine in plane.items():
            r = hop(mine)
            if use_pallas:
                mx = ops.gossip_mix(mine, r, None, alpha, beta)
            else:
                # (w_keep·mine + rw·recv) / denom in float32, each operation
                # rounded as out of place, in two buffers: mine's copy and
                # the hop's (its own when float32)
                mf = mine.to(torch.float32, copy=True).mul_(w_keep[:, None])
                mf.add_(r.to(torch.float32).mul_(rw[:, None]))
                mx = mf.div_(denom[:, None]).to(mine.dtype)
            del r
            mixed[name] = mx if use is None else torch.where(
                _rows_mask(use, mine), mx, mine)
        return mixed, new_w

    return mix


def gossip_lane(part: FlatPartition, M: int, shifts: Sequence[int], *,
                use_pallas: bool = False,
                mesh: Optional[WorkerMesh] = None):
    """Tree-level gossip for the lockstep LayUp step, whose state stays a
    parameter tree: pack the stacked tree into the plane through ``part``,
    mix each group (:func:`gossip_plane_lane`; ``use_pallas``: the pure
    ``gossip_mix`` kernel), unpack (views of the mixed plane). Returns
    ``mix(tree, w, shift_idx) -> (tree, w)``; the identity when M == 1.
    ``mesh``: the rank's ``(L, ...)`` tree, as :func:`gossip_plane_lane`."""
    if M == 1:
        return lambda tree, w, shift_idx, alive=None: (tree, w)
    plane_mix = gossip_plane_lane(part, M, shifts, use_pallas=use_pallas,
                                  mesh=mesh)

    def mix(tree, w, shift_idx, alive=None):
        plane, w = plane_mix(part.pack(tree), w, shift_idx, alive=alive)
        return part.unpack(plane), w

    return mix


def gossip_fused_lane(part: FlatPartition, M: int, shifts: Sequence[int], *,
                      use_pallas: bool = True, wire: str = "param",
                      mesh: Optional[WorkerMesh] = None):
    """The paper's Alg. 1 ordering, fused: ship the PRE-update plane, then
    one pass per group computes ``mixed = α·x + β·recv + upd`` (3 reads + 1
    write). Returns ``mix_apply(plane, updates, w, shift_idx) -> (plane,
    w)``. At M == 1 it is a fused ``x + upd`` (α=1, β=0), still one pass
    per group.

    ``use_pallas=True`` sends each group through the kernels of
    ``kernels.ops`` (on a CUDA tensor: ``gossip_mix``, ``quantize_plane``,
    ``dequant_mix``); ``False`` calls their plain versions directly, the
    same arithmetic in PyTorch ops. The result is written into ``plane``'s
    buffers in place, or into the buffers of ``out`` (a dict like
    ``plane``) when it is given: the stream engine's ping-pong planes.

    ``wire="int8"``: per group, quantize the pre-update plane with its
    error-feedback residual (the residual rewritten in place), roll ``q``
    and the scales by the same shift, and mix with one ``dequant_mix`` pass
    ``α·x + β·(q·s) + upd``. Only one group's ``q`` and its received copy
    are alive at a time. The signature becomes ``mix_apply(plane, resid,
    updates, w, shift_idx) -> (plane, resid, w)``; at M == 1 the residual
    passes through untouched.

    ``alive=`` (a device mask, see :func:`_ring_exchange`) gates the hop.
    The mix writes in place, so the gate goes into its operands, not a
    select after it: a degraded row (``use`` false) receives its own
    buffer with ``α = 1, β = 0`` and computes ``op(x, x, u, 1, 0)``, its
    own update and nothing of the dead source's row; on the int8 wire its
    received scales are zeroed instead.

    ``mesh`` (a :class:`WorkerMesh` with a process group) runs the lane on
    the rank's ``(L, n)`` rows, as :func:`gossip_plane_lane`: q and the
    scales cross ranks by the same hop, the kernels see ``(L, n)``
    buffers."""
    _check_wire(wire, 0.0)
    op = ops.gossip_mix if use_pallas else gossip_mix_ref
    loc = _local_fn(mesh)

    def apply_m1(plane, updates, w, out):
        one, zero = torch.ones_like(loc(w)), torch.zeros_like(loc(w))
        return {name: op(x, x, updates[name], one, zero, out=out[name])
                for name, x in plane.items()}

    def weights(w, shift_idx, alive):
        hop, w_keep, rw, use = _ring_exchange(w, shift_idx, shifts, alive,
                                              mesh)
        new_w, _, alpha, beta = _mix_weights(w_keep, rw, use)
        alpha, beta, use = loc(alpha), loc(beta), loc(use)
        if use is not None:
            # a degraded row applies its own update and mixes nothing in
            alpha = torch.where(use, alpha, torch.ones_like(alpha))
            beta = torch.where(use, beta, torch.zeros_like(beta))
        return hop, use, new_w, alpha, beta

    if wire == "int8":
        qfn = ops.quantize_plane if use_pallas else quantize_plane_ref
        dqfn = ops.dequant_mix if use_pallas else dequant_mix_ref

        def mix_apply_q(plane, resid, updates, w, shift_idx, out=None,
                        alive=None):
            out = plane if out is None else out
            if M == 1:
                return apply_m1(plane, updates, w, out), resid, w
            hop, use, new_w, alpha, beta = weights(w, shift_idx, alive)
            mixed = {}
            for name, x in plane.items():
                q, s, _ = qfn(x, resid[name], out_resid=resid[name])
                q_recv, s_recv = hop(q), hop(s)
                del q, s
                if use is not None:
                    # a degraded row reads zero scales: β·(q·0) = 0
                    s_recv = torch.where(_rows_mask(use, s_recv), s_recv,
                                         torch.zeros_like(s_recv))
                mixed[name] = dqfn(x, q_recv, s_recv, updates[name], alpha,
                                   beta, out=out[name])
                del q_recv, s_recv
            return mixed, resid, new_w

        return mix_apply_q

    def mix_apply(plane, updates, w, shift_idx, out=None, alive=None):
        out = plane if out is None else out
        if M == 1:
            return apply_m1(plane, updates, w, out), w
        hop, use, new_w, alpha, beta = weights(w, shift_idx, alive)
        mixed = {}
        for name, x in plane.items():
            r = hop(x)
            if use is not None:
                # a degraded row receives its own buffer: op(x, x, u, 1, 0)
                torch.where(_rows_mask(use, x), r, x, out=r)
            mixed[name] = op(x, r, updates[name], alpha, beta, out=out[name])
            del r
        return mixed, new_w

    return mix_apply


# ---------------------------------------------------------------------------
# the decoupled step
# ---------------------------------------------------------------------------


def alive_on_device(alive, device, cache: Dict[tuple, torch.Tensor]):
    """The device copy of a host membership mask (``state["alive"]``, numpy
    float32) when some peer is dead, else ``None`` (the ungated route: with
    every peer alive the gated step gives the same bits, and costs
    plane-sized selects). One copy to the device per distinct mask, kept in
    ``cache``: a step reads no mask back from the device."""
    if alive is None or bool((np.asarray(alive) > 0).all()):
        return None
    key = tuple(float(v) for v in np.asarray(alive))
    if key not in cache:
        cache[key] = torch.tensor(key, dtype=torch.float32, device=device)
    return cache[key]


def gate_update(lane_out, write, alive) -> Dict[str, torch.Tensor]:
    """A dead peer applies no updates. ``lane_out`` is the update lane's
    output: the deltas (``write`` is None: the fused route), zeroed in
    place for dead rows, or the updated plane, whose dead rows keep
    ``write``'s. Both are selects, never a multiply by the mask (Inf·0 is
    NaN)."""
    keep = alive > 0.0
    if write is None:
        for u in lane_out.values():
            u.masked_fill_(~_rows_mask(keep, u), 0.0)
        return lane_out
    return {k: torch.where(_rows_mask(keep, v), v, write[k])
            for k, v in lane_out.items()}


def live_loss(losses: Sequence[torch.Tensor], alive,
              mesh: Optional[WorkerMesh] = None):
    """The mean of the per-worker losses; over the live peers only when a
    device mask is given (a dead peer's loss must not drag the mean).
    ``mesh`` (with a process group): ``losses`` are the rank's L workers',
    gathered over the ranks in global row order before the mean, so that
    it is the one-process mean bit for bit (the reference's ``pmean``)."""
    stacked = torch.stack(list(losses))
    if mesh is not None:
        stacked = mesh.all_gather_rows(stacked)
    if alive is None:
        return stacked.mean()
    return (stacked * alive).sum() / alive.sum()


def stamp_live(versions, stamp, alive):
    """Each group's clock stamped ``t + φ_g``; a dead peer's clocks freeze
    at its last live generation."""
    stamped = stamp_groups(versions, stamp)
    if alive is None:
        return stamped
    return torch.where((alive > 0.0)[:, None], stamped, versions)


def _decoupled_worker_fn(part: FlatPartition, fwd: Callable, upd: Callable,
                         mix: Optional[Callable], M: int, D: int, *,
                         active_fn: Optional[Callable] = None,
                         fused_mix: Optional[Callable] = None,
                         mesh: Optional[WorkerMesh] = None,
                         drift: bool = False):
    """The decoupled step over the stacked workers (all M, or with a
    ``mesh`` of a process group this rank's L rows):
    ``step(state, batch, step_idx, shift_idx) -> (state, metrics)``.

    Order: forward on the READ plane → delayed update on the WRITE plane →
    gossip (``fused_mix`` folds apply+mix; else apply then ``mix``) → the
    read plane adopts the mixed write plane → each group's clock is stamped
    ``t + φ_g`` (only when M > 1: with one worker nothing is received).
    ``batch`` carries a leading worker axis on every leaf: the step's rows
    (``(L,)`` on a mesh). On a mesh the per-worker losses are gathered and
    ``nonfinite_skips`` summed over the ranks.

    A state with ``"resid"`` (``wire="int8"``, see
    :func:`make_decoupled_state`) threads the error-feedback residual
    plane through the gossip lane, whose signature then takes it; one with
    ``"theta"`` (``compensate > 0``) threads θ through the update lane,
    which must have been built with ``compensate > 0``. Both are consumed
    in place like the rest of the state.

    A state with ``"alive"`` (membership, DESIGN.md §15: the host mask of
    the chaos controller) adds ``peers_live`` to the metrics; while a peer
    is dead the step is alive-gated: a dead peer applies no updates, its
    clocks freeze, the gossip hop is gated, and the loss is averaged over
    the live peers.

    ``drift`` adds the disagreement diagnostic of the new read plane
    (``repro_torch.core.api.disagreement``) to the metrics as
    ``"disagreement"``.

    The step runs in a ``step`` lane span, and its lanes in ``fwd`` and
    ``bwd`` (the forward lane's), ``pack``, ``update``, ``gossip`` and
    ``drift`` spans inside it (``repro_torch.launch.timeline``)."""
    phi = send_fractions(part.num_groups)
    phi_on: Dict[torch.device, torch.Tensor] = {}  # φ copied once per device
    masks: Dict[tuple, torch.Tensor] = {}  # device copies of host masks
    loc = _local_fn(mesh)
    row_elements = sum(part.group_sizes.values())
    if drift:
        from repro_torch.core.api import disagreement

    def step(state, batch, step_idx, shift_idx):
        with span("step", step=step_idx):
            return lanes(state, batch, step_idx, shift_idx)

    def lanes(state, batch, step_idx, shift_idx):
        read, write = state["read"], state["write"]
        opt_state, w, versions = state["opt"], state["w"], state["versions"]
        fifo = state.get("fifo", ())
        alive_host = state.get("alive")
        alive = alive_on_device(alive_host, w.device, masks)
        grads = {k: torch.empty_like(v) for k, v in read.items()}
        losses = []
        for m in range(next(iter(read.values())).shape[0]):
            loss_m, g_m = fwd(part.unpack({k: v[m] for k, v in read.items()}),
                              {k: v[m] for k, v in batch.items()}, worker=m)
            with span("pack", worker=m, work=row_elements):
                part.pack(g_m, out={k: v[m] for k, v in grads.items()})
            del g_m
            losses.append(loss_m)
        resid, theta = state.get("resid"), state.get("theta")
        with span("update", work=write):
            active = (loc(active_fn(step_idx)) if active_fn is not None
                      else None)
            upd_out = upd(write, opt_state, grads, fifo, step_idx,
                          active=active, theta=theta)
            del grads
            # lane_out: the update deltas on the fused route, else the
            # updated write plane
            lane_out, opt_state, fifo, upd_stale, skips = upd_out[:5]
            if theta is not None:
                theta = upd_out[5]
            del upd_out
            if mesh is not None:
                skips = mesh.all_reduce_sum_(skips)
            if alive is not None:
                lane_out = gate_update(
                    lane_out, None if fused_mix is not None else write,
                    loc(alive))
        int8 = resid is not None
        with span("gossip", work=write):
            if fused_mix is not None:
                if int8:
                    write, resid, w = fused_mix(write, resid, lane_out, w,
                                                shift_idx, alive=alive)
                else:
                    write, w = fused_mix(write, lane_out, w, shift_idx,
                                         alive=alive)
            elif int8:
                write, resid, w = mix(lane_out, resid, w, shift_idx,
                                      alive=alive)
            else:
                write, w = mix(lane_out, w, shift_idx, alive=alive)
            del lane_out
            read = write
            if M > 1:
                if versions.device not in phi_on:
                    phi_on[versions.device] = torch.from_numpy(phi).to(
                        versions.device)
                stamp = phi_on[versions.device] + float(np.float32(step_idx))
                versions = stamp_live(versions, stamp, alive)
        loss = live_loss(losses, alive, mesh)
        new_state = {"read": read, "write": write, "opt": opt_state, "w": w,
                     "versions": versions}
        if D > 0:
            new_state["fifo"] = fifo
        if int8:
            new_state["resid"] = resid
        if theta is not None:
            new_state["theta"] = theta
        if alive_host is not None:
            new_state["alive"] = alive_host
        metrics = _decoupled_metrics(w, versions, loss, upd_stale, step_idx,
                                     skips, alive_host)
        if drift:
            with span("drift", work=read):
                metrics["disagreement"] = disagreement(read, w, mesh=mesh)
        return new_state, metrics

    return step


def make_decoupled_state(params_stacked, optimizer: Optimizer, *,
                         update_delay: int = 0,
                         part: Optional[FlatPartition] = None,
                         wire: str = "param", compensate: float = 0.0,
                         membership: bool = False,
                         mesh: Optional[WorkerMesh] = None):
    """Initial step state: the params packed ONCE into the stacked plane,
    as two separate copies (read, write), optimizer state in plane layout,
    push-sum weights ``1/M``, zero version clocks and, with D > 0, a zero
    gradient FIFO with stamps −1. ``wire="int8"`` adds the zero
    error-feedback residual plane ``"resid"`` (the plane's dtypes);
    ``compensate > 0`` adds ``"theta"``, a third copy of the initial plane
    (the θ_prev of step 0); ``membership`` adds ``"alive"``, the host
    membership mask (numpy float32, all ones; the chaos controller replaces
    it at fault events, DESIGN.md §15).

    ``mesh`` (with a process group): ``params_stacked`` holds the rank's L
    workers; the plane, optimizer state, FIFO, residual and θ get L rows,
    the push-sum weights ``1/M`` and the clocks all M."""
    _check_wire(wire, compensate)
    leaves, _ = tree_flatten(params_stacked)
    M = leaves[0].shape[0] if mesh is None else mesh.workers
    if mesh is not None and leaves[0].shape[0] != mesh.local_workers:
        raise ValueError(f"the mesh's rank holds {mesh.local_workers} "
                         f"workers, the params {leaves[0].shape[0]}")
    D = int(update_delay)
    if part is None:
        part = FlatPartition(tree_map(lambda x: x[0], params_stacked))
    plane = part.pack(params_stacked)
    read = {k: v.clone(memory_format=torch.contiguous_format)
            for k, v in plane.items()}
    write = {k: v.clone(memory_format=torch.contiguous_format)
             for k, v in plane.items()}
    theta = None
    if float(compensate) > 0.0:
        theta = {k: v.clone(memory_format=torch.contiguous_format)
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
        state["fifo"] = fifo_init({k: v[0] for k, v in read.items()}, D,
                                  leaves[0].shape[0])
    if wire == "int8":
        state["resid"] = {k: torch.zeros_like(v) for k, v in read.items()}
    if theta is not None:
        state["theta"] = theta
    if membership:
        state["alive"] = np.ones((M,), np.float32)
    return state


def _gossip_lanes(part: FlatPartition, M: int, shifts: Sequence[int], *,
                  use_pallas: bool, wire: str,
                  mesh: Optional[WorkerMesh] = None):
    """``(mix, fused_mix)`` of the decoupled step: the fused Alg. 1 lane on
    ``use_pallas``, else the plain plane lane."""
    if use_pallas:
        return None, gossip_fused_lane(part, M, shifts, wire=wire, mesh=mesh)
    return gossip_plane_lane(part, M, shifts, wire=wire, mesh=mesh), None


def _decoupled_metrics(w, versions, loss, upd_stale, step_idx, skips,
                       alive=None):
    out = {"loss": loss, "update_staleness": upd_stale,
           "weight_sum": torch.sum(w), "nonfinite_skips": skips}
    if alive is not None:
        # the host mask's count, a host tensor: no read from the device
        out["peers_live"] = torch.tensor(float(np.sum(alive)),
                                         dtype=torch.float32)
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


def _ring_mesh(mesh: Optional[WorkerMesh], M: int) -> Optional[WorkerMesh]:
    """``mesh`` when it spreads the workers over a process group (checked
    against ``M``), else ``None``: the one-process lanes."""
    if mesh is None:
        return None
    if not isinstance(mesh, WorkerMesh):
        raise TypeError(f"expected a WorkerMesh, got {mesh!r}")
    if mesh.workers != M:
        raise ValueError(f"the mesh has {mesh.workers} workers, expected "
                         f"M={M}")
    return mesh if mesh.group is not None else None


def published_rows(mesh: Optional[WorkerMesh]) -> Optional[range]:
    """The global rows a rank's published plane holds (``None``: all M,
    the one-process plane)."""
    return None if mesh is None or mesh.group is None else mesh.rows


def rank_rows(batch, mesh: Optional[WorkerMesh]):
    """The rank's rows of a batch in the worker layout (leading ``(M,)``
    axis on every leaf; views); the batch itself without a process
    group."""
    if mesh is None or mesh.group is None:
        return batch
    return tree_map(mesh.local, batch)


def make_decoupled_backend_trainer(loss_fn: Callable, optimizer: Optimizer,
                                   schedule: Callable, M: int, *,
                                   device=None,
                                   shifts: Sequence[int] = (1, 2, 4, 8),
                                   fb_ratio: int = 1, update_delay: int = 0,
                                   straggler_delays=None,
                                   measure_drift: bool = False,
                                   use_pallas: bool = False,
                                   wire: str = "param",
                                   compensate: float = 0.0,
                                   membership: bool = False,
                                   publisher=None,
                                   mesh: Optional[WorkerMesh] = None):
    """Decoupled LayUp over a params dict + ``loss_fn``: the engine behind
    the ``"prod"`` backend. ``M`` workers are stacked on ``device`` (the
    reference takes a mesh with M devices on its worker axis), or, with a
    ``mesh`` of a process group, this rank's L of them on the mesh's
    device.

    Batches use the sim layout: every leaf carries a leading ``(M,)``
    worker axis (on every rank of a mesh, which keeps its own rows). Only
    the flat plane is ported. ``use_pallas=True`` is the
    fused Alg. 1 route through the kernels (:func:`gossip_fused_lane`); the
    default applies the update and then mixes in plain PyTorch
    (:func:`gossip_plane_lane`). ``wire`` (``"param"`` or ``"int8"``) and
    ``compensate=λ ≥ 0`` are the options of DESIGN.md §14; ``membership``
    adds the alive mask to the state (DESIGN.md §15).

    ``publisher`` (a :class:`repro_torch.serving.PlanePublisher`) receives
    the read plane, version clocks, push-sum weights and drift after every
    step. The step consumes its state in place, so the publish is
    ``stable=False``: the publisher copies the plane on the device. On a
    mesh with a process group a rank publishes its rows, and the snapshot
    names them (``rows``).

    Returns ``(init_fn, step_fn, shifts, box)`` as the reference does:
    ``init_fn(rng, params_single) -> state``, ``step_fn(state, batch,
    step_idx, shift_idx) -> (state, metrics)``, the effective gossip shift
    set, and ``box["part"]`` (the FlatPartition, after ``init_fn``)."""
    _check_wire(wire, compensate)
    ring = _ring_mesh(mesh, M)
    device = resolve_device(device) if ring is None else \
        ring.resolved_device()
    L = M if ring is None else ring.local_workers
    R, D = int(fb_ratio), int(update_delay)
    shifts = tuple(s % M for s in shifts if s % M != 0) or (1,)
    active_fn = straggler_active_fn(M, straggler_delays, device)
    part_box: Dict[str, Any] = {}

    def build(params_single):
        part = FlatPartition(params_single)
        fwd = forward_lane(loss_fn, fb_ratio=R)
        upd = backward_update_lane(optimizer, schedule, update_delay=D,
                                   apply=not use_pallas,
                                   compensate=compensate)
        mix, fused = _gossip_lanes(part, M, shifts, use_pallas=use_pallas,
                                   wire=wire, mesh=ring)
        step = _decoupled_worker_fn(part, fwd, upd, mix, M, D,
                                    active_fn=active_fn, fused_mix=fused,
                                    mesh=ring, drift=measure_drift)
        return step, part

    def init_fn(rng, params_single):
        del rng
        params_single = to_torch(params_single, device)
        stacked = tree_map(lambda p: p[None].expand((L,) + tuple(p.shape)),
                           params_single)
        if "step" not in part_box:
            part_box["step"], part_box["part"] = build(params_single)
        return make_decoupled_state(stacked, optimizer, update_delay=D,
                                    part=part_box["part"], wire=wire,
                                    compensate=compensate,
                                    membership=membership, mesh=ring)

    def step_fn(state, batch, step_idx, shift_idx):
        if "step" not in part_box:
            raise RuntimeError("call init_fn before step_fn")
        batch = rank_rows(to_torch(batch, device), ring)
        with torch.no_grad():
            new_state, metrics = part_box["step"](state, batch, int(step_idx),
                                                  int(shift_idx))
        if publisher is not None:
            publisher.publish(new_state["read"], new_state["versions"],
                              new_state["w"], int(step_idx),
                              drift=metrics.get("disagreement"),
                              stable=False, rows=published_rows(ring))
        return new_state, metrics

    return init_fn, step_fn, shifts, part_box


# ---------------------------------------------------------------------------
# the Model-level step factories
# ---------------------------------------------------------------------------


def _spec(t: torch.Tensor) -> Tuple[Tuple[int, ...], torch.dtype]:
    """A tensor's abstract form: its ``(shape, dtype)`` pair."""
    return tuple(t.shape), t.dtype


@dataclass
class ProdStep:
    """A step built from a ``Model`` at a ``ShapeConfig``: ``fn``, the
    abstract arguments it takes (``(shape, dtype)`` pairs, a host integer
    the type ``int``), and ``init_state``, which makes ``fn``'s first state
    from params: DDP ``params -> (params, opt_state)``, lockstep LayUp
    ``stacked params -> (params, opt_state, w)``, the decoupled step
    ``stacked params -> state``. ``chaos`` (set by ``make_step(faults=)``)
    is the :class:`repro_torch.chaos.ChaosController` of the step's fault
    plan: callers run ``chaos.before_step`` at each step boundary."""
    fn: Any
    abstract_args: Tuple[Any, ...]
    describe: str = ""
    chaos: Any = None
    init_state: Optional[Callable] = None


def _mesh_workers(mesh) -> Tuple[int, torch.device]:
    """``(M, device)`` of a :class:`~repro_torch.launch.mesh.WorkerMesh`,
    the device resolved (``None``: CUDA, which must exist)."""
    if not isinstance(mesh, WorkerMesh):
        raise TypeError(f"expected a WorkerMesh, got {mesh!r} (build one "
                        "with WorkerMesh(M, device))")
    return mesh.workers, mesh.resolved_device()


def _mean_over_ranks_(tensors: Sequence[torch.Tensor],
                      mesh: WorkerMesh) -> None:
    """Each tensor summed over the mesh's ranks and divided by their
    number, in place: one all-reduce per dtype, over a flat copy."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        mesh.all_reduce_sum_(flat).div_(mesh.world)
        lo = 0
        for t in ts:
            t.copy_(flat[lo:lo + t.numel()].view(t.shape))
            lo += t.numel()


def worker_batch(batch, M: int):
    """The global batch in the worker layout: each leaf's batch dim
    (:func:`_batch_dim`) cut into M contiguous shards, shard ``m`` worker
    ``m``'s, on a new leading axis (views). The reference's ``shard_map``
    over the worker axes gives each worker the same rows."""
    def split(x):
        d = _batch_dim(x)
        n = x.shape[d]
        if n % M:
            raise ValueError(f"global batch of {n} does not split over {M} "
                             f"workers (leaf shape {tuple(x.shape)})")
        return x.unflatten(d, (M, n // M)).movedim(d, 0)

    return tree_map(split, batch)


def _rank_batch_rows(tree, ring: Optional[WorkerMesh]):
    """The rank's contiguous share of each leaf's batch dim
    (:func:`_batch_dim`); the tree itself without ``ring``."""
    if ring is None:
        return tree
    return tree_map(lambda x: x[ring.rank],
                    worker_batch(tree, ring.world))


def _stacked_meta(tree, M: int):
    """A meta tree with a leading worker axis of M (nothing allocated)."""
    return tree_map(lambda t: t.expand((M,) + tuple(t.shape)), tree)


def _lead(tree):
    """Every leaf with a leading axis of 1 (views): one replica as a worker
    axis, the layout of the update lane."""
    return tree_map(lambda x: x[None], tree)


def _unlead(tree):
    return tree_map(lambda x: x[0], tree)


def make_ddp_train_step(model, mesh, optimizer: Optimizer,
                        schedule: Callable, shape: ShapeConfig) -> ProdStep:
    """The synchronous baseline: one replica over the global batch, one
    forward and backward, the optimizer on the whole gradient (on a mesh of
    many devices the reference's GSPMD all-reduces it; here the one replica
    holds it). ``fn(params, opt_state, batch, step_idx) -> (params,
    opt_state, loss)``; the optimizer state is over the params'
    ``{leaf_key: leaf}`` dict (``init_state(params)``) and is updated in
    place.

    On a mesh with a process group every rank holds the replica and takes
    its ``1/world`` of the global batch (the contiguous shard ``rank``);
    the gradient leaves are summed over the ranks and divided by ``world``
    before the same optimizer, and the loss is the ranks' mean: one replica
    over the global batch, to rounding."""
    _, device = _mesh_workers(mesh)
    ring = mesh if mesh.group is not None else None
    part = LayerPartition(model.abstract_params())
    fwd = forward_lane(model.loss_fn)
    upd = backward_update_lane(optimizer, schedule)

    def step(params, opt_state, batch, step_idx):
        batch = _rank_batch_rows(to_torch(batch, device), ring)
        with torch.no_grad():
            loss, grads = fwd(params, batch)
            if ring is not None:
                loss = loss.clone()
                _mean_over_ranks_([loss] + tree_leaves(grads), ring)
            new, opt_state, _, _, _ = upd(
                _lead(part.by_key(params)), _lead(opt_state),
                _lead(part.by_key(grads)), (), int(step_idx))
            del grads
        return part.from_keys(_unlead(new)), _unlead(opt_state), loss

    def init_state(params):
        params = to_torch(params, device)
        return params, optimizer.init(part.by_key(params))

    abstract_params = model.abstract_params()
    abstract = (tree_map(_spec, abstract_params),
                tree_map(_spec, optimizer.init(part.by_key(abstract_params))),
                input_specs(model.cfg, shape), int)
    return ProdStep(step, abstract, "ddp train", init_state=init_state)


def make_layup_train_step(model, mesh, optimizer: Optimizer,
                          schedule: Callable, shape: ShapeConfig,
                          shifts: Sequence[int] = (1, 2, 4, 8),
                          accum_steps: int = 1,
                          use_pallas: bool = False) -> ProdStep:
    """The lockstep LayUp step: every worker runs forward and backward on
    its shard of the global batch (``accum_steps`` microbatches each),
    applies its update, and the stacked tree is mixed over the ring, one
    layer group at a time (:func:`gossip_lane`; ``use_pallas``: the pure
    ``gossip_mix`` kernel). ``fn(params, opt_state, w, batch, step_idx,
    shift_idx) -> (params, opt_state, w, loss)``: ``params`` the stacked
    ``(M, ...)`` tree, the optimizer state over its ``{leaf_key: (M, ...)}``
    dict (``init_state``), ``w`` the ``(M,)`` push-sum weights, ``loss`` the
    mean over the workers.

    On a mesh with a process group the rank runs its L workers: ``params``
    and the optimizer state hold its ``(L, ...)`` rows (``init_state``
    takes all M and keeps them), ``w`` stays ``(M,)``, the step takes the
    global batch and keeps the rank's shards, and the mix crosses ranks."""
    M, device = _mesh_workers(mesh)
    ring = _ring_mesh(mesh, M)
    L = M if ring is None else ring.local_workers
    shifts = tuple(s % M for s in shifts if s % M != 0) or (1,)
    part = FlatPartition(model.abstract_params())
    fwd = forward_lane(model.loss_fn, accum_steps=accum_steps)
    upd = backward_update_lane(optimizer, schedule)
    mix = gossip_lane(part, M, shifts, use_pallas=use_pallas, mesh=ring)

    def step(params, opt_state, w, batch, step_idx, shift_idx):
        batch = rank_rows(worker_batch(to_torch(batch, device), M), ring)
        with torch.no_grad():
            keyed = part.by_key(params)
            grads = {k: torch.empty_like(v) for k, v in keyed.items()}
            losses = []
            for m in range(L):
                loss_m, g_m = fwd(tree_map(lambda x: x[m], params),
                                  {k: v[m] for k, v in batch.items()})
                for k, g in part.by_key(g_m).items():
                    grads[k][m].copy_(g)
                del g_m
                losses.append(loss_m)
            new, opt_state, _, _, _ = upd(keyed, opt_state, grads, (),
                                          int(step_idx))
            del grads
            params, w = mix(part.from_keys(new), w, int(shift_idx))
        return params, opt_state, w, live_loss(losses, None, ring)

    def init_state(params_stacked):
        params = tree_map(
            lambda x: x.to(device).clone(
                memory_format=torch.contiguous_format),
            rank_rows(params_stacked, ring))
        return (params, optimizer.init(part.by_key(params)),
                torch.full((M,), 1.0 / M, dtype=torch.float32,
                           device=device))

    stacked = _stacked_meta(model.abstract_params(), L)
    abstract = (tree_map(_spec, stacked),
                tree_map(_spec, optimizer.init(part.by_key(stacked))),
                ((M,), torch.float32), input_specs(model.cfg, shape),
                int, int)
    return ProdStep(step, abstract,
                    f"layup train (M={M}, shifts={shifts}"
                    f"{f', accum={accum_steps}' if accum_steps > 1 else ''}"
                    f"{', pallas' if use_pallas else ''})",
                    init_state=init_state)


def make_layup_decoupled_train_step(model, mesh, optimizer: Optimizer,
                                    schedule: Callable, shape: ShapeConfig,
                                    shifts: Sequence[int] = (1, 2, 4, 8),
                                    fb_ratio: int = 2,
                                    update_delay: int = 1,
                                    use_pallas: bool = False,
                                    wire: str = "param",
                                    compensate: float = 0.0,
                                    membership: bool = False) -> ProdStep:
    """The paper's decoupled step at the Model level: the lanes of
    :func:`make_decoupled_backend_trainer` over ``model.loss_fn``, taking
    the global batch (split over the workers by :func:`worker_batch`).
    ``fn(state, batch, step_idx, shift_idx) -> (state, metrics)``, the
    state from ``init_state(stacked params)`` (:func:`make_decoupled_state`
    with the step's flags), consumed in place. On a mesh with a process
    group the rank runs its L workers: ``init_state`` takes all M stacked
    params and keeps the rank's rows, the step takes the global batch and
    keeps the rank's shards."""
    M, device = _mesh_workers(mesh)
    ring = _ring_mesh(mesh, M)
    L = M if ring is None else ring.local_workers
    R, D = int(fb_ratio), int(update_delay)
    if shape.global_batch % (M * max(R, 1)):
        raise ValueError(
            f"global_batch={shape.global_batch} must divide by "
            f"M*R={M}*{R} for the decoupled forward lane")
    shifts = tuple(s % M for s in shifts if s % M != 0) or (1,)
    _check_wire(wire, compensate)
    part = FlatPartition(model.abstract_params())
    fwd = forward_lane(model.loss_fn, fb_ratio=R)
    upd = backward_update_lane(optimizer, schedule, update_delay=D,
                               apply=not use_pallas, compensate=compensate)
    mix, fused = _gossip_lanes(part, M, shifts, use_pallas=use_pallas,
                               wire=wire, mesh=ring)
    base_step = _decoupled_worker_fn(part, fwd, upd, mix, M, D,
                                     fused_mix=fused, mesh=ring)

    def step(state, batch, step_idx, shift_idx):
        batch = rank_rows(worker_batch(to_torch(batch, device), M), ring)
        with torch.no_grad():
            return base_step(state, batch, int(step_idx), int(shift_idx))

    def init_state(params_stacked):
        return make_decoupled_state(
            to_torch(rank_rows(params_stacked, ring), device), optimizer,
            update_delay=D, part=part, wire=wire, compensate=compensate,
            membership=membership, mesh=ring)

    meta = part.abstract_plane((L,))
    plane = tree_map(_spec, meta)
    abstract_state = {"read": plane, "write": plane,
                      "opt": tree_map(_spec, optimizer.init(meta)),
                      "w": ((M,), torch.float32),
                      "versions": ((M, part.num_groups), torch.float32)}
    if D > 0:
        abstract_state["fifo"] = {
            "g": {k: ((L, D) + tuple(b.shape[1:]), b.dtype)
                  for k, b in meta.items()},
            "stamp": ((D,), torch.float32)}
    if wire == "int8":
        abstract_state["resid"] = plane
    if float(compensate) > 0.0:
        abstract_state["theta"] = plane
    if membership:
        abstract_state["alive"] = ((M,), torch.float32)
    abstract = (abstract_state, input_specs(model.cfg, shape), int, int)
    return ProdStep(step, abstract,
                    f"layup decoupled train (M={M}, R={R}, D={D}, "
                    f"shifts={shifts}"
                    f"{', pallas' if use_pallas else ''}"
                    f"{', wire=int8' if wire == 'int8' else ''}"
                    f"{f', comp={compensate}' if compensate else ''}"
                    f"{', membership' if membership else ''})",
                    init_state=init_state)


def _serve_ring(mesh: WorkerMesh, B: int) -> Optional[WorkerMesh]:
    """The mesh whose ranks split a serving batch of ``B`` rows: a mesh
    with a process group when ``B`` divides over its ranks; else ``None``,
    and every rank runs the whole batch (the reference's replicated batch,
    ``db = None``)."""
    if mesh.group is None or B % mesh.world:
        return None
    return mesh


def make_prefill_step(model, mesh, shape: ShapeConfig) -> ProdStep:
    """``fn(params, batch) -> (cache, last_logits)``: ``model.prefill_fn``
    on the batch (the flash forward on the card).

    On a mesh with a process group every rank holds the params; the
    batch's rows are split over the ranks when ``global_batch`` divides by
    their number (rank r takes the contiguous share r), else every rank
    runs the whole batch. The cache stays the rank's (its rows); the
    logits are gathered in row order, the global batch's on every rank."""
    _, device = _mesh_workers(mesh)
    ring = _serve_ring(mesh, shape.global_batch)

    def step(params, batch):
        batch = _rank_batch_rows(to_torch(batch, device), ring)
        cache, logits = model.prefill_fn(params, batch)
        if ring is not None:
            logits = ring.all_gather_rows(logits)
        return cache, logits

    abstract = (tree_map(_spec, model.abstract_params()),
                input_specs(model.cfg, shape))
    return ProdStep(step, abstract,
                    "prefill" if ring is None else
                    f"prefill (rows over {ring.world} ranks)")


def make_decode_step(model, mesh, shape: ShapeConfig) -> ProdStep:
    """``fn(params, cache, token, position) -> (logits, cache)``:
    ``model.decode_fn``, the cache written in place (the reference donates
    it). The cache's abstract form is ``model.cache_specs(B, seq_len)``.

    On a mesh with a process group, as :func:`make_prefill_step`: the
    token and position rows are split over the ranks when ``B`` divides by
    their number, and the cache holds the rank's ``B / world`` rows (the
    one its prefill made); the logits are gathered in row order."""
    _mesh_workers(mesh)
    B = shape.global_batch
    ring = _serve_ring(mesh, B)
    B_rank = B if ring is None else B // ring.world

    def step(params, cache, token, position):
        token, position = _rank_batch_rows((token, position), ring)
        logits, cache = model.decode_fn(params, cache, token, position)
        if ring is not None:
            logits = ring.all_gather_rows(logits)
        return logits, cache

    abstract = (tree_map(_spec, model.abstract_params()),
                model.cache_specs(B_rank, shape.seq_len),
                ((B, 1), torch.int32), ((B,), torch.int32))
    return ProdStep(step, abstract,
                    "decode" if ring is None else
                    f"decode (rows over {ring.world} ranks)")


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------


def make_step(model, mesh, shape: ShapeConfig, *, algo: str = "layup",
              optimizer: Optional[Optimizer] = None,
              schedule: Optional[Callable] = None,
              shifts: Sequence[int] = (1, 2, 4, 8),
              accum_steps: int = 1,
              fb_ratio: int = 1,
              update_delay: int = 0,
              overlap: bool = False,
              flat: bool = True,
              use_pallas: bool = False,
              streams: int = 1,
              wire: str = "param",
              compensate: float = 0.0,
              faults=None,
              max_inflight_steps: Optional[int] = None,
              tuning=None):
    """The step of ``model`` at ``shape`` on ``mesh`` (a
    :class:`~repro_torch.launch.mesh.WorkerMesh`: M workers on one device,
    ``WorkerMesh(M, "cpu")`` on the CPU; with a process group, each rank's
    L workers on its own device), routed as the reference's:

    * ``shape.kind == "train"``: ``algo="ddp"`` is
      :func:`make_ddp_train_step`; ``fb_ratio > 1``, ``update_delay > 0``
      or ``overlap`` the decoupled LayUp step
      (:func:`make_layup_decoupled_train_step`, or with ``overlap=True``
      the stage-graph engines of ``repro_torch.launch.pipeline``, ``streams
      > 1`` on CUDA streams of their own); else lockstep LayUp
      (:func:`make_layup_train_step`, with ``accum_steps``);
    * ``"prefill"`` / ``"decode"``: :func:`make_prefill_step` /
      :func:`make_decode_step`.

    ``use_pallas``, ``wire`` and ``compensate`` are the decoupled lane's
    options (DESIGN.md §11, §14); ``use_pallas`` also routes the lockstep
    mix through the pure ``gossip_mix`` kernel. ``flat=False`` (the
    reference's legacy per-leaf state, which gives its flat plane's numbers
    bit for bit) runs on the flat plane, the port's one state layout.
    ``faults`` (a ``FaultPlan`` or its spec) turns on membership in the
    decoupled lane and attaches a ``ChaosController`` as ``.chaos``.
    ``tuning`` (a ``TuningRecord`` or the path of one) replaces the
    schedule defaults still at their documented values and implies
    ``overlap=True``; a record that fails to load warns and changes
    nothing. The default optimizer is momentum 0.9 with its state in the
    model's dtype, the default schedule a constant 0.1.

    On a mesh with a process group every route and option runs over the
    ranks: the training routes with ``overlap``, ``streams``, ``faults``
    (the controller replicated on every rank) and ``tuning`` (the resolved
    schedule must agree over the ranks, else every rank raises
    ``RuntimeError``), and prefill and decode on the rank's share of the
    batch."""
    from repro_torch.optim import constant, momentum
    del flat
    optimizer = optimizer or momentum(0.9, state_dtype=model.cfg.dtype)
    schedule = schedule or constant(0.1)
    if tuning is not None:
        from repro_torch.launch.tuner import apply_tuning, resolve_tuning
        record = resolve_tuning(tuning)
        if record is not None:
            tuned = apply_tuning(record, fb_ratio=fb_ratio,
                                 update_delay=update_delay,
                                 max_inflight_steps=max_inflight_steps)
            fb_ratio = tuned["fb_ratio"]
            update_delay = tuned["update_delay"]
            max_inflight_steps = tuned["max_inflight_steps"]
            overlap = True
        if isinstance(mesh, WorkerMesh):
            mesh.agree(None if record is None else
                       [int(fb_ratio), int(update_delay), max_inflight_steps,
                        bool(overlap)], "tuning schedules")
    decoupled = fb_ratio > 1 or update_delay > 0 or overlap
    membership = faults is not None
    if streams > 1 and not overlap:
        raise ValueError("streams > 1 is a property of the stage-graph "
                         "pipeline; it requires overlap=True")
    _check_wire(wire, compensate)
    if (wire != "param" or float(compensate) > 0.0 or membership) \
            and not decoupled:
        raise ValueError("wire='int8' / compensate > 0 / faults belong to "
                         "the decoupled LayUp lane (fb_ratio/update_delay/"
                         "overlap)")
    if decoupled and (shape.kind != "train" or algo == "ddp"):
        raise ValueError(
            "fb_ratio/update_delay/overlap define the decoupled LayUp lane; "
            f"they do not apply to algo={algo!r} kind={shape.kind!r}")
    if shape.kind == "train":
        if algo == "ddp":
            return make_ddp_train_step(model, mesh, optimizer, schedule,
                                       shape)
        if decoupled:
            if accum_steps > 1:
                raise ValueError(
                    "the decoupled lane does not compose with accum_steps")
            lane = dict(shifts=shifts, fb_ratio=fb_ratio,
                        update_delay=update_delay, use_pallas=use_pallas,
                        wire=wire, compensate=compensate,
                        membership=membership)
            if overlap:
                from repro_torch.launch.pipeline import \
                    make_layup_decoupled_pipeline
                step = make_layup_decoupled_pipeline(
                    model, mesh, optimizer, schedule, shape, streams=streams,
                    max_inflight_steps=max_inflight_steps, **lane)
            else:
                step = make_layup_decoupled_train_step(
                    model, mesh, optimizer, schedule, shape, **lane)
            if membership:
                from repro_torch.chaos import ChaosController
                step.chaos = ChaosController(
                    faults, mesh.workers, update_delay=update_delay,
                    compensate=compensate, mesh=mesh)
                engine = getattr(step, "engine", None)
                step.chaos.attach(engine=engine,
                                  board=getattr(engine, "board", None))
            return step
        return make_layup_train_step(model, mesh, optimizer, schedule, shape,
                                     shifts, accum_steps, use_pallas)
    if shape.kind == "prefill":
        return make_prefill_step(model, mesh, shape)
    return make_decode_step(model, mesh, shape)
