"""Distributed-algorithm API v2 and the simulation-backend trainer (port of
``repro/core/api.py``).

Every algorithm (LayUp and all baselines) is a ``DistAlgorithm`` with four
hooks operating on a :class:`~repro_torch.core.layerview.LayerView`:

  init_extras(view, M)                   → algorithm-private state
  transform_grads(grads, extras)         → grads (DDP: mean over workers)
  pre(view, weights, extras, step)       → applied before the forward pass
                                           (e.g. delayed/buffered gossip)
  post(view, weights, extras, updates, active, rng, step)
                                         → applies local updates + mixing
                                           and stamps the version clocks

``make_sim_trainer`` wires a model loss, an optimizer, a schedule and an
algorithm into a step over M workers stacked on one device. The state
keeps the parameters on the flat plane of
:class:`~repro_torch.core.layerview.FlatPartition`, as the prod lane does:
one ``(M, n)`` buffer per layer group (and dtype), and the hooks receive
that plane as ``view.groups``. Every hook is elementwise over the worker
axis or reduces along it alone, so it computes on the concatenated buffer
what the JAX package computes leaf by leaf. The version clocks keep one
column per layer group (``LayerPartition.names``): a group whose leaves
have two dtypes has two buffers and one clock.

Differences from the JAX package, none of them in the numbers:

* ``step`` is a host integer, so the hooks branch on the host where the
  reference selects with ``jnp.where`` (SlowMo, CO2 and Local SGD compute
  their averages only on the steps that sync).
* Random draws come from a ``torch.Generator`` on the state's device
  (``rng``), through two module-level functions, :func:`draw_peers` here
  and ``adpsgd.draw_permutation``, which the parity tests replace by the
  reference's draws for the same step.
* The workers' forward and backward passes run one after the other
  (``ops.FlashAttention`` has no vmap rule), each writing its gradients
  into its row of a stacked gradient plane.
* The delay-D gradient FIFO is a ring of D planes indexed by ``step % D``
  (the reference shifts a stacked FIFO every step): the same values, and
  the same zeros while it warms up.

Decoupled execution (the paper's PD-ASGD mechanism, DESIGN.md §3):
``fb_ratio=R`` splits each worker's batch into R forward passes of which
one receives a backward, and ``update_delay=D`` applies each gradient D
iterations after its forward (``update_staleness``, ``layer_staleness``).
``straggler_delays[i] = d`` makes worker ``i`` perform its local update
and gossip only every ``d+1`` iterations (asynchronous algorithms only).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import to_torch
from repro_torch.core.layerview import (FlatPartition, LayerView,
                                        version_metrics)
from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.launch.train import combine_slice_losses, forward_slice_lane
from repro_torch.optim.optimizers import Optimizer

# ---------------------------------------------------------------------------


@dataclass
class TrainState:
    """The sim trainer's state. ``params`` is the stacked flat plane
    ``{buffer: (M, n)}`` (the JAX package keeps the stacked tree; the
    trainer's ``FlatPartition`` unpacks one from the other), ``opt_state``
    the optimizer's state in plane layout, ``step`` a host integer and
    ``delay`` the gradient FIFO: ``{"g": [plane] * D, "stamp": [float] *
    D}`` indexed by ``step % D`` (``()`` when D == 0)."""
    params: Dict[str, torch.Tensor]
    opt_state: Any
    weights: torch.Tensor          # (M,) push-sum weights (sum == 1)
    extras: Any                    # algorithm-private
    step: int
    versions: torch.Tensor = None  # (M, G) per-group version clocks
    delay: Any = ()


class DistAlgorithm:
    """Base class; subclasses override the hooks they need.

    ``view.groups`` is a tree of stacked ``(M, ...)`` leaves (the sim
    trainer's flat plane, or a ``LayerPartition.split``), so the hooks map
    over it with ``tree_map``; ``view.versions`` is the per-group
    staleness clock the algorithm stamps whenever remote information is
    incorporated. ``pre`` and ``post`` CONSUME ``view.groups``: they write
    the new parameters into its buffers (:func:`columns_`), where the
    reference's pure hooks return new arrays; at GPT-2 Medium, M=4 that
    saves a plane of 7.3 GB and whole-group temporaries."""

    name: str = "base"
    asynchronous: bool = False  # respects the straggler active-mask

    def init_extras(self, view: LayerView, M: int):
        return ()

    def transform_grads(self, grads, extras):
        return grads, extras

    def pre(self, view: LayerView, weights, extras, step: int):
        return view, weights, extras

    def post(self, view: LayerView, weights, extras, updates, active, rng,
             step: int):
        raise NotImplementedError

    # -- shared helpers -------------------------------------------------------
    @staticmethod
    def _bcast(v: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
        """A per-worker (M,) vector shaped to broadcast against a leaf."""
        return v.reshape((-1,) + (1,) * (leaf.dim() - 1)).to(torch.float32)

    @classmethod
    def masked_apply(cls, params, updates, active):
        """params + updates where active (per-worker mask), written into
        the params' buffers."""
        a = active.to(torch.float32)

        def f(p, u):
            return p + (cls._bcast(a, p) * u.to(torch.float32)).to(p.dtype)
        return tree_map(lambda p, u: columns_(f, p, u), params, updates)


# elements of a worker row a hook computes at a time: its f32 temporaries
# stay at M × 64 MB instead of whole-group planes
_HOOK_CHUNK = 1 << 24


def columns_(fn: Callable, x: torch.Tensor, *others) -> torch.Tensor:
    """``x ← fn(x, *others)`` in place, a chunk of columns at a time.

    ``fn`` maps stacked ``(M, ...)`` operands elementwise over the columns
    (it may mix rows: a gather or a mean over workers) to a result shaped
    like ``x``; each call sees every row of one chunk of columns, so the
    result is the whole call's, element for element, while its temporaries
    stay chunk-sized. The hooks write their new parameters this way: the
    sim trainer's step consumes its state, as the prod lane's does."""
    if not (x.is_contiguous() and all(o.is_contiguous() for o in others)):
        return x.copy_(fn(x, *others))
    M = x.shape[0]
    xs = x.view(M, -1)
    os = [o.reshape(M, -1) for o in others]
    for lo in range(0, xs.shape[1], _HOOK_CHUNK):
        hi = lo + _HOOK_CHUNK
        xs[:, lo:hi].copy_(fn(xs[:, lo:hi], *(o[:, lo:hi] for o in os)))
    return x


def add_(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``p + u`` in the params' dtype, written into ``p``."""
    return columns_(lambda a, b: a + b.to(a.dtype), p, u)


# ---------------------------------------------------------------------------
# gossip peer selection with collision-skip (paper §3.1)
# ---------------------------------------------------------------------------


def draw_peers(rng: Optional[torch.Generator], M: int, device
               ) -> torch.Tensor:
    """M uniform draws from ``[0, M-1)`` on ``device``, from ``rng`` (the
    reference's ``jax.random.randint(rng, (M,), 0, M - 1)``)."""
    return torch.randint(0, M - 1, (M,), generator=rng, device=device)


def choose_peers(rng, M: int, active: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Random peer per active worker; colliding senders are skipped (the
    lowest sender index wins: a deterministic stand-in for the race's
    winner).

    Returns (send_ok (M,) bool, has_recv (M,) bool, sender_idx (M,) int64
    — valid where has_recv). One worker has no peer: nothing is sent."""
    device = active.device
    if M == 1:
        none = torch.zeros((1,), dtype=torch.bool, device=device)
        return none, none.clone(), torch.zeros((1,), dtype=torch.int64,
                                               device=device)
    me = torch.arange(M, device=device)
    peers = draw_peers(rng, M, device).to(torch.int64)
    peers = peers + (peers >= me).to(torch.int64)  # j != i
    contestant = torch.where(active, me, torch.full_like(me, M))
    winner = torch.full((M,), M, dtype=torch.int64, device=device)
    winner.scatter_reduce_(0, peers, contestant, reduce="amin")
    send_ok = active & (winner[peers] == me)
    has_recv = winner < M
    sender_idx = torch.where(has_recv, winner, torch.zeros_like(winner))
    return send_ok, has_recv, sender_idx


def pushsum_weight_update(weights, send_ok, has_recv, sender_idx):
    """w_i ← w_i/2 on send; w_j ← w_j + w_s/2 on receive. Σw conserved."""
    w = torch.where(send_ok, weights * 0.5, weights)
    gain = torch.where(has_recv, weights[sender_idx] * 0.5,
                       torch.zeros_like(weights))
    return w + gain


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_ALGOS: Dict[str, Callable[..., DistAlgorithm]] = {}


def register_algorithm(name: str):
    def deco(fn):
        _ALGOS[name] = fn
        return fn
    return deco


def get_algorithm(name: str, **kw) -> DistAlgorithm:
    _ensure_loaded()
    if name not in _ALGOS:
        raise KeyError(f"unknown algorithm {name!r}; known: {sorted(_ALGOS)}")
    return _ALGOS[name](**kw)


def list_algorithms():
    _ensure_loaded()
    return sorted(_ALGOS)


def _ensure_loaded():
    # importing each module registers its algorithms; a module is imported
    # once per process, so this is idempotent
    for m in ("ddp", "layup", "gosgd", "adpsgd", "localsgd", "slowmo", "co2"):
        importlib.import_module(f"repro_torch.core.{m}")


# ---------------------------------------------------------------------------
# consensus and drift
# ---------------------------------------------------------------------------


def consensus(params, weights: torch.Tensor):
    """Push-sum consensus estimate x̄ = Σ_i w_i x_i / Σ_i w_i over the
    leading worker axis of every leaf."""
    wsum = torch.clamp(torch.sum(weights), min=1e-12)

    def f(p):
        w = weights.reshape((-1,) + (1,) * (p.dim() - 1)).to(torch.float32)
        return torch.sum(w * p.to(torch.float32), dim=0) / wsum
    return tree_map(f, params)


# elements of a worker row that the disagreement reduces at a time: its f32
# temporaries stay at M × 64 MB instead of whole-plane copies
_DRIFT_CHUNK = 1 << 24


def disagreement(params, weights: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean over workers of ‖x_i − x̄‖ (the paper's 'model disagreement'),
    x̄ the push-sum consensus. Each leaf is reduced a chunk of its row at a
    time, so no plane-sized f32 copy is made; the sums' order differs from
    the JAX package's by rounding only.

    ``mesh`` (a :class:`~repro_torch.launch.mesh.WorkerMesh` with a process
    group): ``params`` hold the rank's L rows and ``weights`` all M. Each
    chunk's ``Σ w_i x_i`` over the rank's rows is summed over the ranks to
    form x̄ (``Σ w`` is the whole vector's, on every rank), and the
    per-worker squared norms are gathered before the mean: the one-process
    value to rounding."""
    ring = mesh is not None and mesh.group is not None
    wsum = torch.clamp(torch.sum(weights), min=1e-12)
    w = (mesh.local(weights) if ring else weights).to(torch.float32)[:, None]
    per_worker = 0.0
    for p in tree_leaves(params):
        rows = p.reshape(p.shape[0], -1)
        for lo in range(0, rows.shape[1], _DRIFT_CHUNK):
            pc = rows[:, lo:lo + _DRIFT_CHUNK].to(torch.float32)
            wx = torch.sum(w * pc, dim=0)
            if ring:
                mesh.all_reduce_sum_(wx)
            xbar = wx / wsum
            per_worker = per_worker + torch.sum(
                torch.square(pc - xbar[None]), dim=1)
    if ring:
        per_worker = mesh.all_gather_rows(per_worker)
    return torch.mean(torch.sqrt(per_worker))


# ---------------------------------------------------------------------------
# sim trainer
# ---------------------------------------------------------------------------


def _split_fwd_lane(batch, R: int):
    """Split each worker's batch into R forward slices along the batch dim
    (dim 1 of the stacked batch). Slice 0 feeds the backward lane;
    slices 1..R-1 are forward-only passes."""
    def check(x):
        if x.dim() < 2 or x.shape[1] % R:
            raise ValueError(
                f"fb_ratio={R} needs per-worker batch divisible by {R}; "
                f"got leaf shape {tuple(x.shape)}")
        return x

    tree_map(check, batch)
    return [tree_map(
        lambda x: x[:, (x.shape[1] // R) * r:(x.shape[1] // R) * (r + 1)],
        batch) for r in range(R)]


def _rows(tree, m: int):
    return tree_map(lambda v: v[m], tree)


def make_sim_trainer(algo: DistAlgorithm, loss_fn: Callable,
                     optimizer: Optimizer, schedule: Callable, M: int,
                     straggler_delays=None, measure_drift: bool = True,
                     fb_ratio: int = 1, update_delay: int = 0, *,
                     device=None, box: Optional[Dict[str, Any]] = None):
    """Returns (init_fn, step_fn).

    ``loss_fn(params, batch) -> (loss, metrics)`` on one worker's tree;
    batches carry a leading ``(M,)`` worker axis on every leaf.
    ``init_fn(rng, params_single) -> TrainState`` (``rng`` unused: the
    workers start from the same parameters) and ``step_fn(state, batch,
    rng) -> (state, metrics)``, ``rng`` a ``torch.Generator`` on
    ``device`` for the algorithm's draws. A step CONSUMES the state it is
    given, as the reference's donated step: its buffers are updated in
    place and its fields released (``None``), so that no plane of the old
    state outlives its use; keep the returned state.

    ``device`` (default CUDA, which must exist) holds the state; ``box``,
    when given, receives the ``FlatPartition`` under ``"part"`` at init.
    """
    if fb_ratio < 1 or update_delay < 0:
        raise ValueError("fb_ratio must be >= 1 and update_delay >= 0")
    device = resolve_device(device)
    D, R = int(update_delay), int(fb_ratio)
    box = {} if box is None else box
    delays = (None if straggler_delays is None else
              torch.as_tensor(np.asarray(straggler_delays), dtype=torch.int64,
                              device=device))
    all_active = torch.ones((M,), dtype=torch.bool, device=device)
    grad_lane = forward_slice_lane(loss_fn)

    def init_fn(rng, params_single) -> TrainState:
        del rng
        params_single = to_torch(params_single, device)
        part = FlatPartition(params_single)
        box["part"] = part
        stacked = tree_map(lambda p: p[None].expand((M,) + tuple(p.shape)),
                           params_single)
        params = {k: v.clone(memory_format=torch.contiguous_format)
                  for k, v in part.pack(stacked).items()}
        delay = ()
        if D > 0:
            # FIFO slots in the params' dtypes, as the prod lane's fifo_init
            delay = {"g": [{k: torch.zeros_like(v) for k, v in params.items()}
                           for _ in range(D)],
                     "stamp": [-1.0] * D}
        versions = part.init_versions(M, device=device)
        return TrainState(
            params=params, opt_state=optimizer.init(params),
            weights=torch.full((M,), 1.0 / M, dtype=torch.float32,
                               device=device),
            extras=algo.init_extras(LayerView(params, versions, part.names),
                                    M),
            step=0, versions=versions, delay=delay)

    def forward(params, batch, part):
        """Every worker's loss and gradients (the latter packed into a
        stacked plane): slice 0 with a backward, slices 1..R-1 forward
        only, workers one after the other."""
        slices = _split_fwd_lane(batch, R) if R > 1 else [batch]
        grads = {k: torch.empty_like(v) for k, v in params.items()}
        losses = []
        for m in range(M):
            p_m = part.unpack(_rows(params, m))
            loss_m, g_m = grad_lane(p_m, _rows(slices[0], m))
            part.pack(g_m, out=_rows(grads, m))
            del g_m
            rest = [loss_fn(p_m, _rows(s, m))[0] for s in slices[1:]]
            losses.append(combine_slice_losses(loss_m, rest, R))
        return torch.mean(torch.stack(losses)), grads

    @torch.no_grad()
    def step_fn(state: TrainState, batch, rng=None):
        if "part" not in box:
            raise RuntimeError("call init_fn before step_fn")
        part = box["part"]
        step = int(state.step)
        batch = to_torch(batch, device)
        view = LayerView(state.params, state.versions, part.names)
        opt_state, delay = state.opt_state, state.delay
        weights, extras = state.weights, state.extras
        # consumed: the caller's state keeps no plane alive during the step
        state.params = state.opt_state = state.extras = state.delay = None
        view, weights, extras = algo.pre(view, weights, extras, step)
        params = view.groups
        if algo.asynchronous and delays is not None:
            active = torch.remainder(step, delays + 1) == 0
        else:
            active = all_active

        loss, grads = forward(params, batch, part)

        # -- backward lane: delay-D gradient FIFO (a ring of D planes) -------
        stale = 0.0
        if D > 0:
            slot = step % D
            applied = delay["stamp"][slot]
            grads, delay["g"][slot] = delay["g"][slot], grads
            delay["stamp"][slot] = float(step)
            if applied >= 0.0:
                stale = float(np.float32(step) - np.float32(applied))
        update_staleness = torch.full((), stale, dtype=torch.float32,
                                      device=device)

        grads, extras = algo.transform_grads(grads, extras)
        lr = schedule(step)
        updates, opt_state = optimizer.update(grads, opt_state, params, lr)
        del grads
        view, weights, extras, algo_metrics = algo.post(
            view, weights, extras, updates, active, rng, step)
        del updates
        params = view.groups
        metrics = {"loss": loss, "lr": lr,
                   "weight_sum": torch.sum(weights),
                   "update_staleness": update_staleness,
                   **version_metrics(view.versions, step),
                   **algo_metrics}
        if measure_drift:
            metrics["disagreement"] = disagreement(params, weights)
        new_state = TrainState(params=params, opt_state=opt_state,
                               weights=weights, extras=extras,
                               step=step + 1, versions=view.versions,
                               delay=delay)
        return new_state, metrics

    return init_fn, step_fn
