"""Event-driven wall-clock simulator for the distributed algorithms.

A copy of ``repro/core/simulator.py`` (numpy only; the port keeps its own
copy and imports nothing of the JAX package). The paper's *timing* claims
(TTC, MFU, straggler robustness — Tables 1–4, Fig. 3) are about clusters of
many workers; this simulator models the schedule each algorithm induces:

  worker i, iteration k:  fwd (F_i) → bwd (B_i) → algorithm-specific comm
  * DDP        — global barrier after bwd, then ring all-reduce
                 (2·(M−1)/M · P bytes at bus bandwidth).
  * LocalSGD / SlowMo — barrier + all-reduce every H iterations only.
  * CO2        — barrier every H iterations, all-reduce *overlapped* (hidden
                 unless it exceeds H·(F+B) of compute).
  * GoSGD      — no barrier; full-model push (P bytes) on the sender NIC
                 after bwd; stalls only if the previous send is in flight.
  * AD-PSGD    — no barrier, but symmetric pairwise averaging (2·P bytes)
                 requires rendezvous with a random partner → a straggler
                 delays whoever draws it.
  * LayUp      — no barrier; layer-wise sends start DURING bwd (layer ℓ's
                 message enters the NIC when its gradient is ready), so
                 communication hides behind the remaining backward compute.

The machinery is an incremental :class:`EventSimulator` — one ``step()``
per update iteration — exposing the same per-iteration cadence as the
numeric sim trainer so both run behind the ``TrainerBackend`` protocol
(repro_torch.core.backend, DESIGN.md §7). ``simulate`` is the batch wrapper.

**Decoupled thread lanes** (the paper's PD-ASGD mechanism, DESIGN.md §3):
``fb_ratio=R`` / ``update_delay=D`` switch the async gossip algorithms to
two per-worker lanes — a forward lane running R forward passes per update
and a backward lane consuming the activations of the forward from D updates
ago. Compute never stalls on the NIC or on update locks (messages queue;
updates land late instead), so utilization pins at the kernel ceiling while
the forward lane serves samples at R× the update rate — this is what makes
the paper's R > 1 throughput and MFU claims simulable.

Stragglers: worker i's compute is scaled by (1 + delay_i) — the paper's
"idle for a multiple of one fwd+bwd" injection (§5.4).

Outputs per algorithm: wall-clock for N iterations, compute utilization
(busy/total), and MFU = utilization × kernel_mfu (the achievable MFU of the
pure compute kernels) — reproducing the structure of paper Table 4/Fig. 3B.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

SYNC_ALGOS = ("ddp", "localsgd", "slowmo", "co2")
GOSSIP_ALGOS = ("gosgd", "layup", "layup-block", "layup-hypercube", "adpsgd")
LAYERWISE_ALGOS = ("layup", "layup-hypercube")


@dataclass
class HardwareModel:
    fwd_time: float = 1.0          # seconds per fwd pass (per worker)
    bwd_ratio: float = 2.0         # bwd = ratio * fwd (paper Table A4: ~2x)
    num_layers: int = 24
    model_bytes: float = 1.6e9     # fp32 GPT-2 medium ≈ 1.6 GB
    bandwidth: float = 25e9        # bytes/s per link (NVLink-ish)
    allreduce_bandwidth: float = 100e9  # bus bandwidth for ring all-reduce
    kernel_mfu: float = 0.75       # MFU of the pure compute kernels

    @property
    def bwd_time(self):
        return self.fwd_time * self.bwd_ratio

    @property
    def iter_compute(self):
        return self.fwd_time + self.bwd_time


@dataclass
class SimResult:
    total_time: float
    compute_time: float   # mean per-worker busy compute time
    utilization: float
    mfu: float
    iter_times: np.ndarray = field(repr=False, default=None)
    updates_per_s: float = 0.0
    fwd_passes_per_s: float = 0.0
    mean_grad_staleness: float = 0.0  # decoupled: activation age in seconds


def _mfu(hw: HardwareModel, compute: float, total: float) -> float:
    return hw.kernel_mfu * compute / max(total, 1e-12)


class EventSimulator:
    """Incremental per-iteration event simulator.

    ``step()`` advances every worker by one update iteration and returns the
    iteration's timing metrics; ``result()`` aggregates into a
    :class:`SimResult`. The batch helper :func:`simulate` preserves the
    original closed-form numbers for the synchronous algorithms and the
    NIC-serialized loop for the gossip family.
    """

    def __init__(self, algo: str, *, M: int, hw: HardwareModel,
                 straggler_delays: Optional[np.ndarray] = None,
                 sync_every: int = 8, seed: int = 0,
                 fb_ratio: int = 1, update_delay: int = 0):
        if algo not in SYNC_ALGOS + GOSSIP_ALGOS:
            raise ValueError(f"unknown algo {algo}")
        self.decoupled = fb_ratio > 1 or update_delay > 0
        if self.decoupled and algo not in GOSSIP_ALGOS:
            raise ValueError(
                "decoupled execution (fb_ratio > 1 / update_delay > 0) "
                f"requires an asynchronous gossip algorithm, not {algo!r}")
        if algo == "adpsgd" and self.decoupled:
            raise ValueError("adpsgd's rendezvous semantics do not admit "
                             "decoupled forward/backward lanes")
        self.algo = algo
        self.M = M
        self.hw = hw
        self.H = sync_every
        self.R = int(fb_ratio)
        self.D = int(update_delay)
        delays = (np.zeros(M) if straggler_delays is None
                  else np.asarray(straggler_delays, float))
        slow = 1.0 + delays
        self.F = hw.fwd_time * slow               # (M,)
        self.B = hw.bwd_time * slow
        self.rng = np.random.default_rng(seed)
        self.send_t = hw.model_bytes / hw.bandwidth
        self.ar = 2 * (M - 1) / M * hw.model_bytes / hw.allreduce_bandwidth

        self.k = 0
        self.clock = np.zeros(M)                  # worker-ready time
        self.nic_free = np.zeros(M)               # sender NIC availability
        self.busy = np.zeros(M)                   # per-worker busy compute
        self.fwd_busy = np.zeros(M)               # forward-lane busy time
        self.bwd_busy = np.zeros(M)               # backward-lane busy time
        self.sync_elapsed = 0.0                   # sync algos: scalar clock
        self.it_times: list = []
        # decoupled: forward-completion ring (per worker) for delay D
        self._fwd_done = np.zeros((max(self.D, 1), M))
        self._stale_sum = 0.0

    # -- per-family iteration bodies ----------------------------------------

    def _step_sync(self) -> float:
        F, B, M = self.F, self.B, self.M
        maxFB = (F + B).max()
        self.busy += F + B
        if self.algo == "ddp":
            dt = maxFB + self.ar
        elif self.algo in ("localsgd", "slowmo"):
            dt = maxFB + (self.ar if (self.k + 1) % self.H == 0 else 0.0)
        else:  # co2: all-reduce overlapped, pays only when comm-bound
            dt = maxFB
            if (self.k + 1) % self.H == 0:
                dt += max(0.0, self.ar - self.H * maxFB)
        self.sync_elapsed += dt
        self.clock[:] = self.sync_elapsed
        return dt

    def _step_adpsgd(self) -> float:
        start = self.clock.copy()
        end = start + self.F + self.B
        perm = self.rng.permutation(self.M)
        for a in range(0, self.M - 1, 2):
            i, j = perm[a], perm[a + 1]
            t = max(end[i], end[j]) + 2 * self.send_t
            end[i] = end[j] = t
        self.busy += self.F + self.B
        self.clock = end
        return self.clock.max() - start.max()

    def _step_gossip_coupled(self) -> float:
        start = self.clock.copy()
        comp_end = start + self.F + self.B
        if self.algo in LAYERWISE_ALGOS:
            # layer-wise: message enters the NIC as each layer's grad is
            # ready; the NIC drains P bytes starting after the first layer's
            # gradient (fwd + bwd/L into the iteration)
            first_grad = start + self.F + self.B / self.hw.num_layers
            nic_done = np.maximum(self.nic_free, first_grad) + self.send_t
        else:  # gosgd / layup-block: whole model sent after bwd
            nic_done = np.maximum(self.nic_free, comp_end) + self.send_t
        self.nic_free = nic_done
        # next iteration may start when compute is done AND the NIC backlog
        # is < one message (otherwise buffering would grow)
        self.clock = np.maximum(comp_end, nic_done - self.send_t)
        self.busy += self.F + self.B
        return self.clock.max() - start.max()

    def _step_gossip_decoupled(self) -> float:
        """Two lanes per worker on one compute engine: R forwards then one
        backward, back to back — compute never waits on the NIC (messages
        queue) or on update locks (updates land D iterations late)."""
        start = self.clock.copy()
        fwd_end = start + self.R * self.F
        self.fwd_busy += self.R * self.F
        # backward consumes the forward from D updates ago (already complete
        # by construction — the forward lane runs ahead)
        if self.D and self.k >= self.D:
            src = self._fwd_done[self.k % self.D]
        else:  # warm-up: the FIFO has not wrapped yet
            src = fwd_end
        self._stale_sum += float(np.mean(np.maximum(fwd_end - src, 0.0)))
        bwd_end = fwd_end + self.B
        self.bwd_busy += self.B
        self._fwd_done[self.k % max(self.D, 1)] = fwd_end
        if self.algo in LAYERWISE_ALGOS:
            first_grad = fwd_end + self.B / self.hw.num_layers
            self.nic_free = np.maximum(self.nic_free, first_grad) + self.send_t
        else:
            self.nic_free = np.maximum(self.nic_free, bwd_end) + self.send_t
        self.clock = bwd_end
        self.busy += self.R * self.F + self.B
        return self.clock.max() - start.max()

    # -- public API ----------------------------------------------------------

    def step(self) -> Dict[str, float]:
        if self.algo in SYNC_ALGOS:
            dt = self._step_sync()
        elif self.algo == "adpsgd":
            dt = self._step_adpsgd()
        elif self.decoupled:
            dt = self._step_gossip_decoupled()
        else:
            dt = self._step_gossip_coupled()
        self.k += 1
        self.it_times.append(dt)
        total, comp, util = self._totals()
        return {"iter_time": dt, "total_time": total,
                "utilization": util, "mfu": _mfu(self.hw, comp, total),
                "updates_per_s": self.k / total,
                "fwd_passes_per_s": self.R * self.k / total}

    def _totals(self):
        """(total, comp, util) — O(M) scalars, no history copies."""
        comp = self.busy.mean()
        if self.algo in SYNC_ALGOS:
            total = self.sync_elapsed
            util = comp / max(total, 1e-12)
        elif self.algo == "adpsgd":
            total = self.clock.max()
            util = comp / max(total, 1e-12)
        else:
            # async gossip finishes when the collective work target is met;
            # the slow worker contributes fewer iterations (others are never
            # blocked). Completion = median worker timeline.
            total = float(np.median(self.clock))
            util = comp / min(total if total > 0 else 1,
                              max(self.clock.max(), 1e-12))
        return max(total, 1e-12), comp, util

    def result(self) -> SimResult:
        iters = max(self.k, 1)
        total, comp, util = self._totals()
        return SimResult(
            total, comp, util, _mfu(self.hw, comp, total),
            np.asarray(self.it_times),
            updates_per_s=iters / total,
            fwd_passes_per_s=self.R * iters / total,
            mean_grad_staleness=self._stale_sum / iters if self.decoupled
            else 0.0)


def simulate(algo: str, *, M: int, iters: int, hw: HardwareModel,
             straggler_delays: Optional[np.ndarray] = None,
             sync_every: int = 8, seed: int = 0,
             fb_ratio: int = 1, update_delay: int = 0) -> SimResult:
    sim = EventSimulator(algo, M=M, hw=hw, straggler_delays=straggler_delays,
                         sync_every=sync_every, seed=seed, fb_ratio=fb_ratio,
                         update_delay=update_delay)
    for _ in range(iters):
        sim.step()
    return sim.result()


def straggler_sweep(algos, *, M: int, iters: int, hw: HardwareModel,
                    delays=(0, 1, 2, 4, 8), seed: int = 0) -> Dict[str, list]:
    """Paper Fig. 3B: training time as a function of straggler delay."""
    out: Dict[str, list] = {a: [] for a in algos}
    for d in delays:
        dl = np.zeros(M)
        dl[0] = d
        for a in algos:
            out[a].append(simulate(a, M=M, iters=iters, hw=hw,
                                   straggler_delays=dl, seed=seed).total_time)
    return out
