"""The prod TrainerBackend on one CUDA device (port of the ``"prod"`` kind
of ``repro/core/backend.py``).

``ProdTrainerBackend`` runs the decoupled PD-ASGD step of
``repro_torch.launch.train`` behind the one-step-per-iteration protocol:
``init(rng, params_single) → state`` then ``step(state, batch, rng) →
(state, metrics)``, plus ``summary()``. Batches use the sim layout (leading
``(M,)`` worker axis). The M workers are stacked on one device, the
reference's mesh of M devices. The per-step gossip shift is drawn by a host
numpy generator seeded at init, the same draws as the reference's.

Metrics are device tensors; ``summary()`` and ``drive``'s history read them
on the host.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.launch.train import make_decoupled_backend_trainer

_NUMERIC_SUMMARY_KEYS = ("loss", "disagreement", "staleness_mean",
                         "update_staleness", "weight_sum", "nonfinite_skips")


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, item {item})")


def _numeric_summary(steps: int, last: Dict[str, Any]) -> Dict[str, float]:
    out = {"steps": float(steps)}
    for k in _NUMERIC_SUMMARY_KEYS:
        if k in last:
            out[k] = float(last[k])
    return out


class ProdTrainerBackend:
    """The decoupled LayUp lane with M workers stacked on one device.

    Keyword arguments keep the reference's names so a call ports one to
    one. ``use_pallas=True`` is the fused Alg. 1 route through the
    ``gossip_mix`` kernel; the default applies each update and then mixes
    in plain PyTorch. ``device`` (default ``"cuda"``, which must exist)
    replaces the reference's ``mesh``. The options of later slices raise
    ``NotImplementedError`` naming the ROADMAP item that ports them."""

    kind = "prod"

    def __init__(self, algo, loss_fn: Callable, optimizer, schedule,
                 M: int, *, device=None, mesh=None, shifts=(1, 2, 4, 8),
                 fb_ratio: int = 1, update_delay: int = 0,
                 straggler_delays=None, measure_drift: bool = True,
                 overlap: bool = False, flat: bool = True,
                 use_pallas: bool = False, publisher=None,
                 streams: int = 1, wire: str = "param",
                 compensate: float = 0.0, faults=None,
                 max_inflight_steps=None, tuning=None):
        if mesh is not None:
            raise _not_ported("an explicit device mesh (multi-GPU ring)", 15)
        if overlap or max_inflight_steps is not None:
            raise _not_ported("overlap=True (the stage-graph pipeline "
                              "engine)", 9)
        if int(streams) > 1:
            raise _not_ported("streams > 1 (the stream engine)", 9)
        if faults is not None:
            raise _not_ported("faults (chaos injection and membership)", 10)
        if publisher is not None:
            raise _not_ported("publisher (live serving)", 11)
        if tuning is not None:
            raise _not_ported("tuning (the stage autotuner)", 12)
        if wire == "int8" or float(compensate) > 0.0:
            raise _not_ported("wire='int8' and compensate > 0", 8)
        if wire != "param":
            raise ValueError(f"unknown wire dtype {wire!r}")
        if not flat:
            raise _not_ported("flat=False (the legacy per-leaf tree state)",
                              15)
        algo_name = getattr(algo, "name", str(algo))
        if not algo_name.startswith("layup"):
            raise ValueError(
                f"prod backend implements the layup family only, not "
                f"{algo_name!r} (the gossip ring is the algorithm)")
        self.name = f"prod:{algo_name}"
        self.M = M
        self.device = resolve_device(device)
        self._init_fn, self._step_fn, self._shifts, self._engine_box = \
            make_decoupled_backend_trainer(
                loss_fn, optimizer, schedule, M, device=self.device,
                shifts=shifts, fb_ratio=fb_ratio, update_delay=update_delay,
                straggler_delays=straggler_delays,
                measure_drift=measure_drift, use_pallas=use_pallas)
        self._steps = 0
        self._last: Dict[str, Any] = {}
        self._shift_rng = np.random.default_rng(0xC0FFEE)

    @property
    def part(self):
        """The FlatPartition fixing the state's plane layout (after init)."""
        return self._engine_box.get("part")

    def export_params(self, state):
        """Stacked ``(M, ...)`` parameter tree view of the read plane."""
        part = self._engine_box.get("part")
        if part is None:
            raise RuntimeError("call init() before export_params()")
        return part.unpack(state["read"])

    def init(self, rng, params_single):
        self._steps = 0
        self._shift_rng = np.random.default_rng(0xC0FFEE)
        return self._init_fn(rng, params_single)

    def step(self, state, batch, rng=None):
        # ``rng`` belongs to the TrainerBackend protocol; the ring's shift
        # schedule is drawn host-side
        shift_idx = int(self._shift_rng.integers(0, len(self._shifts)))
        state, metrics = self._step_fn(state, batch, self._steps, shift_idx)
        self._steps += 1
        self._last = metrics
        return state, metrics

    def summary(self) -> Dict[str, float]:
        out = _numeric_summary(self._steps, self._last)
        out["wire_dtype"] = "param"
        part = self._engine_box.get("part")
        if part is not None:
            out["wire_bytes_per_round"] = float(part.plane_nbytes())
        return out


def make_backend(kind: str, algo, *, M: int, loss_fn: Callable = None,
                 optimizer=None, schedule=None, **kw) -> ProdTrainerBackend:
    """Entry point over the backends. The port has ``kind="prod"`` so far
    (needs loss_fn, optimizer, schedule; ``device`` defaults to CUDA)."""
    if kind in ("sim", "event"):
        raise _not_ported(f"the {kind!r} backend", 13)
    if kind == "prod":
        if loss_fn is None or optimizer is None or schedule is None:
            raise ValueError("prod backend needs loss_fn, optimizer, schedule")
        return ProdTrainerBackend(algo, loss_fn, optimizer, schedule, M, **kw)
    raise ValueError(
        f"unknown backend kind {kind!r}; use 'sim', 'event' or 'prod'")


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def drive(backend, batches, rng=None, params_single=None,
          history_keys: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """Run a backend over an iterable of batches; collect metric history.

    Returns {"state": final_state, "history": {key: np.ndarray}, and the
    backend's summary() entries}. Reading a history key copies that metric
    to the host after each step."""
    state = backend.init(rng, params_single)
    hist: Dict[str, list] = {k: [] for k in history_keys}
    for batch in batches:
        state, metrics = backend.step(state, batch, rng)
        for k in history_keys:
            if k in metrics:
                hist[k].append(_host(metrics[k]))
    out: Dict[str, Any] = {"state": state,
                           "history": {k: np.asarray(v)
                                       for k, v in hist.items()}}
    out.update(backend.summary())
    return out
