"""The PD-ASGD step (decoupled forward, delayed update, push-sum gossip),
plainly, for M workers, written from the algorithm's description.

Each step ``t`` with ring shift ``s_t``:

1. every worker runs R forward slices of its batch on its parameters x;
   slice 0 also gets a backward pass. Its loss is the mean of the R slice
   losses, the step's loss the mean over workers.
2. the delayed update: the gradient made at step ``t - D`` (zeros before
   any exists) leaves a D-deep FIFO and the new one enters it. With
   ``compensate`` λ > 0 it is corrected to ``g + λ·g·g·(s·(x − θ))``, s
   the staleness, θ the previous step's pre-update parameters. Momentum:
   ``m ← β·m + g``, update ``u = −lr·m``.
3. gossip (push-sum over a ring, the update applied in the same pass):
   worker j keeps half its weight and receives half of worker ``j − s``'s,
   ``α = w_keep / w_new``, ``β = w_recv / w_new``, and
   ``x ← α·x + β·x_{j−s} + u``. On the int8 wire the received plane is
   ``q·scale``: each 128-element row of a layer group's flat buffer
   (leaves flattened in sorted-path order, concatenated) quantized with
   error feedback, ``v = x + r``, ``scale = max|v| / 127``,
   ``q = round(v / scale)``, ``r ← v − q·scale``.
4. each layer group's version clock ``← max(clock, t + φ_g)``,
   ``φ_g = (1 + 2(G − g)/G) / 3``.

Shifts: ``{1, 2, 4, 8} mod M`` without 0, one drawn each step by
``numpy.random.default_rng(0xC0FFEE).integers(0, count)``.

State is kept in the configuration's dtype (parameters, momentum, FIFO,
residual, θ) and every operation is computed in float32 and rounded to it
once, which is what the dtype a configuration states means for stored
state. ``fault`` plants a known fault for the controls: ``"half_batch"``
(every slice's loss over the first half of its rows, or of its positions
where it has one row), ``"no_exchange"``
(nothing received: α = 1, β = 0).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from h100bench.reference import model as ref_model
from h100bench.reference.precision import rounder

LANE = 128
CHUNK = 1 << 22  # columns of the update at a time: a multiple of LANE


def group_layout(shapes: Dict[str, tuple]):
    """{group: [(path, offset, size, shape)]} and {group: size}: group =
    the path's first component; leaves in sorted-path order."""
    groups: Dict[str, list] = {}
    for path in sorted(shapes, key=lambda p: tuple(p.split("/"))):
        g = path.split("/")[0]
        slots = groups.setdefault(g, [])
        off = slots[-1][1] + slots[-1][2] if slots else 0
        size = int(np.prod(shapes[path], dtype=np.int64))
        slots.append((path, off, size, tuple(shapes[path])))
    sizes = {g: s[-1][1] + s[-1][2] for g, s in groups.items()}
    return dict(sorted(groups.items())), dict(sorted(sizes.items()))


def ring_shifts(M: int, candidates=(1, 2, 4, 8)):
    return tuple(s % M for s in candidates if s % M) or (1,)


def shift_draws(M: int, steps: int) -> List[int]:
    shifts = ring_shifts(M)
    rng = np.random.default_rng(0xC0FFEE)
    return [shifts[int(rng.integers(0, len(shifts)))] for _ in range(steps)]


def send_fractions(G: int) -> torch.Tensor:
    """φ_g in float32, each operation rounded in turn."""
    g = torch.arange(G, dtype=torch.float32)
    return (1.0 + 2.0 * (G - g) / G) / 3.0


def quantized(v):
    """(q·scale, v − q·scale) of an (M, n) float32 buffer, per 128-element
    row, zero padded."""
    M, n = v.shape
    rows = -(-n // LANE)
    vp = torch.nn.functional.pad(v, (0, rows * LANE - n)).reshape(M, rows,
                                                                  LANE)
    amax = vp.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(vp / scale), -127.0, 127.0)
    deq = (q * scale).reshape(M, -1)[:, :n]
    return deq, v - deq


class Reference:
    """M workers' PD-ASGD state, all workers starting from ``params``."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict,
                 job: dict, *, precision: str = "float32",
                 fault: Optional[str] = None):
        ref_model.check_config(cfg)
        self.cfg, self.job, self.fault = cfg, job, fault
        self.mm = rounder(precision)
        self.M = M = job["workers"]
        self.dtype = next(iter(params.values())).dtype
        self.layout, sizes = group_layout(
            {k: tuple(v.shape) for k, v in params.items()})
        dev = next(iter(params.values())).device
        self.x = {}
        for g, slots in self.layout.items():
            flat = torch.cat([params[p].reshape(-1) for p, *_ in slots])
            self.x[g] = flat[None].repeat(M, 1)
        self.m = {g: torch.zeros_like(v) for g, v in self.x.items()}
        D = job["update_delay"]
        self.fifo = [{g: torch.zeros_like(v) for g, v in self.x.items()}
                     for _ in range(D)]
        self.stamps = [-1.0] * D
        self.lam = float(job["compensate"])
        self.theta = ({g: v.clone() for g, v in self.x.items()}
                      if self.lam > 0 else None)
        self.int8 = job["wire"] == "int8"
        self.resid = ({g: torch.zeros_like(v) for g, v in self.x.items()}
                      if self.int8 else None)
        self.w = torch.full((M,), 1.0 / M, dtype=torch.float32, device=dev)
        self.versions = torch.zeros((M, len(self.x)), dtype=torch.float32,
                                    device=dev)
        self.phi = send_fractions(len(self.x)).to(dev)

    def leaves(self, planes, m: int) -> Dict[str, torch.Tensor]:
        """Worker m's leaves of a plane dict (views)."""
        return {p: planes[g][m, off:off + size].view(shape)
                for g, slots in self.layout.items()
                for p, off, size, shape in slots}

    def _slice_loss(self, p, batch, r):
        R = self.job["fb_ratio"]
        b = batch["tokens"].shape[0] // R
        part = {k: v[r * b:(r + 1) * b] for k, v in batch.items()}
        if self.fault == "half_batch":
            # the first half of the slice's rows, or of its one row's
            # positions
            half = (slice(0, b // 2),) if b > 1 else \
                (slice(None), slice(0, part["tokens"].shape[1] // 2))
            part = {k: v[half] for k, v in part.items()}
        return ref_model.loss(p, part, self.cfg, self.mm)

    def forward(self, m: int, batch, grads_out=None):
        """Worker m's loss; with ``grads_out`` (planes) also the gradient
        of slice 0, written into row m."""
        R, backward = self.job["fb_ratio"], grads_out is not None
        p = {k: v.detach().to(torch.float32).requires_grad_(backward)
             for k, v in self.leaves(self.x, m).items()}
        with torch.set_grad_enabled(backward):
            l0 = self._slice_loss(p, batch, 0)
            if backward:
                keys = list(p)
                gs = torch.autograd.grad(l0, [p[k] for k in keys])
                for k, gk in zip(keys, gs):
                    self.leaves(grads_out, m)[k].copy_(gk)
                del gs
            l0 = l0.detach()
        with torch.no_grad():
            rest = [self._slice_loss(p, batch, r) for r in range(1, R)]
        return (l0 + sum(rest)) / R if R > 1 else l0

    def _cast(self, v):
        return v.to(self.dtype)

    def step(self, t: int, shift: int, batch, backward: bool = True):
        """One step on ``batch`` (leaves (M, B, S)); returns its loss.
        ``backward=False`` skips the gradient of step t, which only a later
        step would apply."""
        new_g = ({g: torch.empty_like(v) for g, v in self.x.items()}
                 if backward else None)
        losses = [self.forward(m, {k: v[m] for k, v in batch.items()},
                               new_g) for m in range(self.M)]
        with torch.no_grad():
            self._update(t, shift, new_g)
        return torch.stack(losses).mean()

    def _update(self, t, shift, new_g):
        if self.fifo:
            g_apply, stamp = self.fifo.pop(0), self.stamps.pop(0)
            self.fifo.append(new_g)
            self.stamps.append(float(t))
        else:
            g_apply, stamp = new_g, float(t)
        stale = float(t) - stamp if stamp >= 0 else 0.0
        w_keep = self.w * 0.5
        w_recv = torch.roll(self.w * 0.5, shift, 0)
        w_new = w_keep + w_recv
        alpha, beta = (w_keep / w_new)[:, None], (w_recv / w_new)[:, None]
        if self.fault == "no_exchange":
            alpha, beta = torch.ones_like(alpha), torch.zeros_like(beta)
        for g, x in self.x.items():
            # elementwise along a row: a block of columns at a time, every
            # worker's row at once (the ring moves rows), in place
            for lo in range(0, x.shape[1], CHUNK):
                cols = slice(lo, lo + CHUNK)
                self._update_cols(g, cols, g_apply[g][:, cols], stale, shift,
                                  alpha, beta)
        self.w = w_new
        if self.M > 1:
            self.versions = torch.maximum(self.versions, self.phi + float(t))

    def _update_cols(self, g, cols, gr, stale, shift, alpha, beta):
        f32, lr = torch.float32, float(np.float32(self.job["lr"]))
        x = self.x[g][:, cols]
        xf = x.to(f32)
        if self.lam > 0:
            gf = gr.to(f32)
            delta = (xf - self.theta[g][:, cols].to(f32)) * stale
            gr = self._cast(gf + ((self.lam * gf) * gf) * delta)
            self.theta[g][:, cols] = x
        m = self.m[g][:, cols]
        m.copy_(self._cast(self._cast(self.job["optimizer"]["beta"]
                                      * m.to(f32)).to(f32) + gr.to(f32)))
        upd = self._cast(-lr * m.to(f32))
        if self.int8:
            recv, r = quantized(xf + self.resid[g][:, cols].to(f32))
            self.resid[g][:, cols] = self._cast(r)
        else:
            recv = xf
        x.copy_(self._cast(alpha * xf + beta * torch.roll(recv, shift, 0)
                           + upd.to(f32)))


def run(params, batches, cfg, job, steps: int = 3,
        keep: Optional[dict] = None, **kw) -> dict:
    """The reference's readings over ``steps`` steps from ``params``: each
    step's loss, the first gradient each worker's optimizer receives (its
    momentum after step D, as per-leaf norms), each leaf's change after
    the last step (per-leaf norms), the clocks and the push-sum weights.
    The last step's gradient is never applied within the run, so it is
    not computed. ``keep``, where given, receives each leaf's parameters
    after the last step (all workers stacked, on the host)."""
    ref = Reference(params, cfg, job, **kw)
    init = {g: v.clone() for g, v in ref.x.items()}
    D = job["update_delay"]
    shifts = shift_draws(job["workers"], steps)
    out = {"loss": []}
    for t in range(steps):
        loss = ref.step(t, shifts[t], batches[t], backward=t + D < steps)
        out["loss"].append(float(loss))
        if t == D:
            out["grad_norms"] = leaf_norms(ref, ref.m)
    out["update_norms"] = leaf_norms(
        ref, {g: ref.x[g].to(torch.float32) - init[g].to(torch.float32)
              for g in ref.x})
    if keep is not None:
        per = [ref.leaves(ref.x, m) for m in range(ref.M)]
        keep.update({p: torch.stack([w[p] for w in per]).cpu()
                     for p in per[0]})
    out["versions"] = ref.versions.cpu()
    out["w"] = ref.w.cpu()
    return out


def leaf_norm(v: torch.Tensor) -> float:
    """The 2-norm of a tensor: float32 norms of its rows (its leading
    axis: a layer of a stacked leaf), their squares summed in float64."""
    rows = v.reshape(v.shape[0], -1) if v.dim() > 1 else v.reshape(1, -1)
    sq = torch.linalg.vector_norm(rows.to(torch.float32), dim=1)
    return float(sq.to(torch.float64).square().sum().sqrt())


def leaf_norms(ref: Reference, planes) -> Dict[str, List[float]]:
    """{path: [norm of worker m's leaf]}."""
    out = {}
    for m in range(ref.M):
        for p, v in ref.leaves(planes, m).items():
            out.setdefault(p, []).append(leaf_norm(v))
    return out
