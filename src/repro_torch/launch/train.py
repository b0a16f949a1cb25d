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
from repro_torch.kernels.ref import (dequant_mix_ref, gossip_mix_ref,
                                     quantize_plane_ref)
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


def forward_slice_lane(loss_fn: Callable, *, fb_ratio: int = 1,
                       slice_idx: int = 0) -> Callable:
    """ONE forward slice of the forward lane, the unit the pipeline engine
    (``repro_torch.launch.pipeline``) runs as a stage of its own.

    Returns ``fwd(params, batch)``: slice 0, the backward slice, gives
    ``(loss, grads)`` (autograd under ``enable_grad``); slices ``1..R-1``
    give ``(loss, None)``, forward only under ``no_grad``. The slice is cut
    by :func:`_split_fwd_slices`, as in :func:`forward_lane`, which is built
    from these lanes."""
    R, r = int(fb_ratio), int(slice_idx)
    if R < 1:
        raise ValueError("fb_ratio must be >= 1")
    if not 0 <= r < R:
        raise ValueError(f"slice_idx={r} out of range for fb_ratio={R}")

    def fwd(params, batch):
        s = _split_fwd_slices(batch, R)[r] if R > 1 else batch
        if r > 0:
            with torch.no_grad():
                return loss_fn(params, s)[0], None
        leaves, treedef = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, _ = loss_fn(tree_unflatten(treedef, leaves), s)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        return loss.detach(), tree_unflatten(treedef, grads)

    return fwd


def combine_slice_losses(loss0, rest: Sequence, R: int):
    """One worker's loss from its R slices: ``(l0 + sum(rest)) / R``, the
    order the reference's lanes use; slice 0's own loss at R == 1."""
    return (loss0 + sum(rest)) / R if R > 1 else loss0


def forward_lane(loss_fn: Callable, *, fb_ratio: int = 1) -> Callable:
    """Forward (+ autograd backward) on one worker's read parameters.

    Returns ``fwd(params, batch) -> (loss, grads)`` with ``loss`` a 0-d
    tensor and ``grads`` a tree like ``params``. With ``fb_ratio=R > 1``
    only slice 0 gets a backward; the other R-1 slices run forward-only
    under ``no_grad`` and the loss averages all R."""
    R = int(fb_ratio)
    if R < 1:
        raise ValueError("fb_ratio must be >= 1")
    lanes = [forward_slice_lane(loss_fn, fb_ratio=R, slice_idx=r)
             for r in range(R)]

    def fwd(params, batch):
        loss, grads = lanes[0](params, batch)
        rest = [lane(params, batch)[0] for lane in lanes[1:]]
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
        ok = {k: torch.isfinite(g).all(dim=-1) for k, g in grads.items()}
        skips = sum((~o).sum(dtype=torch.float32) for o in ok.values())
        for k, g in grads.items():  # a select, in the consumed buffer
            g.masked_fill_(~ok[k][:, None], 0.0)
        if lam > 0.0:
            for k, g in grads.items():
                _compensate_(g, params[k], theta[k], update_staleness, lam)
        lr = schedule(step_idx)
        updates, opt_state = optimizer.update(grads, opt_state, params, lr)
        del grads
        for k, u in updates.items():
            u.masked_fill_(~ok[k][:, None], 0.0)
            if active is not None:
                u.mul_(active[:, None].to(u.dtype))
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


def _ring_exchange(w, shift_idx, shifts: Sequence[int], alive=None):
    """One push-sum ring hop on the stacked plane: worker ``i`` sends its
    buffers and half its weight to worker ``i + s mod M``, i.e. row ``j``
    receives row ``j − s`` (``torch.roll(buf, s, 0)``).

    Returns ``(hop, w_keep, rw, use)``. ``hop(buf)`` makes the received copy
    of one stacked buffer, so a caller holds one group's copy at a time, and
    every buffer of a round (an int8 group's q and its scales) moves by the
    same shift.

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
    hop = lambda buf: torch.roll(buf, s, 0)  # noqa: E731
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


def gossip_plane_lane(part: FlatPartition, M: int, shifts: Sequence[int], *,
                      wire: str = "param"):
    """Push-sum ring gossip on the stacked flat plane, after the update was
    applied: ``(w/2·mine + w'/2·recv) / (w/2 + w'/2)`` in f32, plain
    PyTorch. Returns ``mix(plane, w, shift_idx) -> (plane, w)``; the
    identity when M == 1.

    ``wire="int8"`` quantizes each outgoing group with its error-feedback
    residual and mixes the received ``{q, scales}`` with
    ``α·mine + β·(q·s)``, ``α = w_keep/w'``, ``β = rw/w'`` (the plain
    ``quantize_plane_ref`` and ``dequant_mix_ref``). The signature becomes
    ``mix(plane, resid, w, shift_idx) -> (plane, resid, w)``; the residual
    is updated in place. At M == 1 it is the identity: nothing crosses the
    wire, nothing is quantized.

    ``alive=`` (a device mask, see :func:`_ring_exchange`) gates the hop:
    a row whose source or self is dead keeps its own buffer (a select, so
    nothing it received is read)."""
    _check_wire(wire, 0.0)
    if wire == "int8":
        if M == 1:
            return lambda plane, resid, w, shift_idx, alive=None: (
                plane, resid, w)

        def mix_q(plane, resid, w, shift_idx, alive=None):
            hop, w_keep, rw, use = _ring_exchange(w, shift_idx, shifts,
                                                  alive)
            new_w, _, alpha, beta = _mix_weights(w_keep, rw, use)
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
        hop, w_keep, rw, use = _ring_exchange(w, shift_idx, shifts, alive)
        new_w, denom, _, _ = _mix_weights(w_keep, rw, use)
        mixed = {}
        for name, mine in plane.items():
            r = hop(mine)
            mf = (w_keep[:, None] * mine.to(torch.float32)
                  + rw[:, None] * r.to(torch.float32)) / denom[:, None]
            del r
            mx = mf.to(mine.dtype)
            mixed[name] = mx if use is None else torch.where(
                _rows_mask(use, mine), mx, mine)
        return mixed, new_w

    return mix


def gossip_fused_lane(part: FlatPartition, M: int, shifts: Sequence[int], *,
                      use_pallas: bool = True, wire: str = "param"):
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
    received scales are zeroed instead."""
    _check_wire(wire, 0.0)
    op = ops.gossip_mix if use_pallas else gossip_mix_ref

    def apply_m1(plane, updates, w, out):
        one, zero = torch.ones_like(w), torch.zeros_like(w)
        return {name: op(x, x, updates[name], one, zero, out=out[name])
                for name, x in plane.items()}

    def weights(w, shift_idx, alive):
        hop, w_keep, rw, use = _ring_exchange(w, shift_idx, shifts, alive)
        new_w, _, alpha, beta = _mix_weights(w_keep, rw, use)
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


def live_loss(losses: Sequence[torch.Tensor], alive):
    """The mean of the per-worker losses; over the live peers only when a
    device mask is given (a dead peer's loss must not drag the mean)."""
    stacked = torch.stack(list(losses))
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
                         fused_mix: Optional[Callable] = None):
    """The decoupled step over all M stacked workers:
    ``step(state, batch, step_idx, shift_idx) -> (state, metrics)``.

    Order: forward on the READ plane → delayed update on the WRITE plane →
    gossip (``fused_mix`` folds apply+mix; else apply then ``mix``) → the
    read plane adopts the mixed write plane → each group's clock is stamped
    ``t + φ_g`` (only when M > 1: with one worker nothing is received).
    ``batch`` carries a leading ``(M,)`` worker axis on every leaf.

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
    the live peers."""
    phi = send_fractions(part.num_groups)
    phi_on: Dict[torch.device, torch.Tensor] = {}  # φ copied once per device
    masks: Dict[tuple, torch.Tensor] = {}  # device copies of host masks

    def step(state, batch, step_idx, shift_idx):
        read, write = state["read"], state["write"]
        opt_state, w, versions = state["opt"], state["w"], state["versions"]
        fifo = state.get("fifo", ())
        alive_host = state.get("alive")
        alive = alive_on_device(alive_host, w.device, masks)
        grads = {k: torch.empty_like(v) for k, v in read.items()}
        losses = []
        for m in range(M):
            loss_m, g_m = fwd(part.unpack({k: v[m] for k, v in read.items()}),
                              {k: v[m] for k, v in batch.items()})
            part.pack(g_m, out={k: v[m] for k, v in grads.items()})
            del g_m
            losses.append(loss_m)
        active = active_fn(step_idx) if active_fn is not None else None
        resid, theta = state.get("resid"), state.get("theta")
        upd_out = upd(write, opt_state, grads, fifo, step_idx, active=active,
                      theta=theta)
        del grads
        # lane_out: the update deltas on the fused route, else the updated
        # write plane
        lane_out, opt_state, fifo, upd_stale, skips = upd_out[:5]
        if theta is not None:
            theta = upd_out[5]
        del upd_out
        if alive is not None:
            lane_out = gate_update(
                lane_out, None if fused_mix is not None else write, alive)
        int8 = resid is not None
        if fused_mix is not None:
            if int8:
                write, resid, w = fused_mix(write, resid, lane_out, w,
                                            shift_idx, alive=alive)
            else:
                write, w = fused_mix(write, lane_out, w, shift_idx,
                                     alive=alive)
        elif int8:
            write, resid, w = mix(lane_out, resid, w, shift_idx, alive=alive)
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
        loss = live_loss(losses, alive)
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
        return new_state, _decoupled_metrics(w, versions, loss, upd_stale,
                                             step_idx, skips, alive_host)

    return step


def make_decoupled_state(params_stacked, optimizer: Optimizer, *,
                         update_delay: int = 0,
                         part: Optional[FlatPartition] = None,
                         wire: str = "param", compensate: float = 0.0,
                         membership: bool = False):
    """Initial step state: the params packed ONCE into the stacked plane,
    as two separate copies (read, write), optimizer state in plane layout,
    push-sum weights ``1/M``, zero version clocks and, with D > 0, a zero
    gradient FIFO with stamps −1. ``wire="int8"`` adds the zero
    error-feedback residual plane ``"resid"`` (the plane's dtypes);
    ``compensate > 0`` adds ``"theta"``, a third copy of the initial plane
    (the θ_prev of step 0); ``membership`` adds ``"alive"``, the host
    membership mask (numpy float32, all ones; the chaos controller replaces
    it at fault events, DESIGN.md §15)."""
    _check_wire(wire, compensate)
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
        state["fifo"] = fifo_init({k: v[0] for k, v in read.items()}, D, M)
    if wire == "int8":
        state["resid"] = {k: torch.zeros_like(v) for k, v in read.items()}
    if theta is not None:
        state["theta"] = theta
    if membership:
        state["alive"] = np.ones((M,), np.float32)
    return state


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
                                   publisher=None):
    """Decoupled LayUp over a params dict + ``loss_fn``: the engine behind
    the ``"prod"`` backend. ``M`` workers are stacked on ``device`` (the
    reference takes a mesh with M devices on its worker axis).

    Batches use the sim layout: every leaf carries a leading ``(M,)``
    worker axis. Only the flat plane is ported. ``use_pallas=True`` is the
    fused Alg. 1 route through the kernels (:func:`gossip_fused_lane`); the
    default applies the update and then mixes in plain PyTorch
    (:func:`gossip_plane_lane`). ``wire`` (``"param"`` or ``"int8"``) and
    ``compensate=λ ≥ 0`` are the options of DESIGN.md §14; ``membership``
    adds the alive mask to the state (DESIGN.md §15).

    ``publisher`` (a :class:`repro_torch.serving.PlanePublisher`) receives
    the read plane, version clocks, push-sum weights and drift after every
    step. The step consumes its state in place, so the publish is
    ``stable=False``: the publisher copies the plane on the device.

    Returns ``(init_fn, step_fn, shifts, box)`` as the reference does:
    ``init_fn(rng, params_single) -> state``, ``step_fn(state, batch,
    step_idx, shift_idx) -> (state, metrics)``, the effective gossip shift
    set, and ``box["part"]`` (the FlatPartition, after ``init_fn``)."""
    _check_wire(wire, compensate)
    device = resolve_device(device)
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
        if use_pallas:
            mix, fused = None, gossip_fused_lane(part, M, shifts, wire=wire)
        else:
            mix, fused = gossip_plane_lane(part, M, shifts, wire=wire), None
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
                                    part=part_box["part"], wire=wire,
                                    compensate=compensate,
                                    membership=membership)

    def step_fn(state, batch, step_idx, shift_idx):
        if "step" not in part_box:
            raise RuntimeError("call init_fn before step_fn")
        batch = to_torch(batch, device)
        with torch.no_grad():
            new_state, metrics = part_box["step"](state, batch, int(step_idx),
                                                  int(shift_idx))
        if publisher is not None:
            publisher.publish(new_state["read"], new_state["versions"],
                              new_state["w"], int(step_idx),
                              drift=metrics.get("disagreement"),
                              stable=False)
        return new_state, metrics

    return init_fn, step_fn, shifts, part_box
