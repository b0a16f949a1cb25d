"""The roofline report's record and the stage floors the autotuner clamps
measured times with (port of ``RooflineReport`` and ``stage_floors`` of
``repro/launch/analysis.py``: plain arithmetic). The rest of that module
(HLO parsing, XLA memory reports, its device constants) is XLA-specific
and not ported (ROADMAP queue 1, item 15); a caller on the card fills a
report's ``t_compute``/``t_memory``/``t_collective`` from the card's own
rates."""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict


@dataclass
class RooflineReport:
    arch: str = ""
    shape: str = ""
    algo: str = ""
    mesh: str = ""
    flops_per_device: float = 0.0
    bytes_per_device: float = 0.0
    collective_wire_bytes: float = 0.0
    collectives: Dict[str, Dict] = field(default_factory=dict)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    dominant: str = ""
    model_flops_total: float = 0.0
    model_flops_per_device: float = 0.0
    useful_ratio: float = 0.0
    memory: Dict[str, float] = field(default_factory=dict)
    xla_raw: Dict[str, float] = field(default_factory=dict)
    detail: Dict[str, Dict] = field(default_factory=dict)
    notes: str = ""

    def to_dict(self):
        return asdict(self)


def stage_floors(report, *, R: int = 1) -> Dict[str, float]:
    """Per-stage roofline lower bounds for the decoupled stage schedule,
    consumed by the autotuner's scorer (``launch/tuner.py``).

    A train step is priced at fwd + 2×bwd + the remat fwd, so one forward
    pass is ~1/4 and the backward+update tail ~3/4 of the device term, the
    binding roof of compute vs memory. With R slices the forward work is
    split R ways, so the per-slice floor divides by R. The gossip floor is
    the collective term unchanged.

    Accepts a :class:`RooflineReport` or its ``to_dict()`` form."""
    if hasattr(report, "t_compute"):
        t_comp = float(report.t_compute)
        t_mem = float(report.t_memory)
        t_coll = float(report.t_collective)
    else:
        t_comp = float(report.get("t_compute", 0.0))
        t_mem = float(report.get("t_memory", 0.0))
        t_coll = float(report.get("t_collective", 0.0))
    dev = max(t_comp, t_mem)
    R = max(int(R), 1)
    return {"fwd": 0.25 * dev / R, "update": 0.75 * dev, "gossip": t_coll}
