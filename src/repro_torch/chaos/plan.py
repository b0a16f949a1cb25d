"""Deterministic fault plans for chaos-testing the async training lane (a
copy of ``repro/chaos/plan.py``: the same grammar, the same errors).

A :class:`FaultPlan` is a seeded, reproducible schedule of fault events —
crash a peer at step t, hang the host loop for s seconds, corrupt or drop
a gossip wire payload, inject a NaN into one layer group's delayed
gradient — that the :class:`~repro_torch.chaos.controller.ChaosController`
replays against a running ``ProdTrainerBackend``. The plan is data, not
behaviour: the same spec string always produces the same event sequence,
so every chaos run is exactly reproducible (DESIGN.md §15).

Spec grammar (semicolon-separated events, ``key=value`` fields)::

    crash:peer=1,step=5            kill peer 1's liveness at step 5
    crash:peer=1,step=5,recover=9  ... and re-admit it at step 9
    hang:step=2,seconds=0.25       host loop sleeps 0.25s before step 2
    nan:step=3,peer=0,group=0      NaN into peer 0's queued grad, group 0
    corrupt:step=4,group=1         flip bytes in group 1's wire payload
    drop:step=6,group=0            group 0's wire payload never arrives
    recover:peer=1,step=9,donor=0  re-sync peer 1 from donor 0

An *empty* plan (``FaultPlan.parse("")``) is a valid no-op schedule: it
turns the membership machinery on without injecting anything, which is
exactly the configuration the bit-exactness tests pin against the
fault-free lane.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

_KINDS = ("crash", "hang", "nan", "corrupt", "drop", "recover")
_MAX_HANG_S = 30.0


@dataclass(frozen=True)
class Fault:
    """One scheduled fault event."""
    kind: str
    step: int
    peer: int = 0
    group: int = 0
    seconds: float = 0.0
    donor: int = -1  # recover: -1 = first live peer

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {_KINDS})")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        if self.kind == "hang" and not 0.0 <= self.seconds <= _MAX_HANG_S:
            raise ValueError(f"hang seconds must be in [0, {_MAX_HANG_S}]")


@dataclass(frozen=True)
class FaultPlan:
    """An ordered, deterministic schedule of :class:`Fault` events."""
    faults: Tuple[Fault, ...] = ()
    seed: int = 0

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        """Parse the spec grammar above. ``""`` is the empty plan."""
        faults: List[Fault] = []
        for ev in (spec or "").split(";"):
            ev = ev.strip()
            if not ev:
                continue
            if ":" not in ev:
                raise ValueError(f"fault event {ev!r} needs 'kind:fields'")
            kind, _, body = ev.partition(":")
            kind = kind.strip()
            fields: Dict[str, str] = {}
            for kv in body.split(","):
                kv = kv.strip()
                if not kv:
                    continue
                if "=" not in kv:
                    raise ValueError(f"fault field {kv!r} needs key=value")
                k, _, v = kv.partition("=")
                fields[k.strip()] = v.strip()
            recover_at = fields.pop("recover", None)
            if recover_at is not None and kind != "crash":
                raise ValueError("recover= sugar only applies to crash")
            if "step" not in fields:
                raise ValueError(f"fault event {ev!r} needs step=")
            faults.append(Fault(
                kind=kind,
                step=int(fields.pop("step")),
                peer=int(fields.pop("peer", 0)),
                group=int(fields.pop("group", 0)),
                seconds=float(fields.pop("seconds", 0.0)),
                donor=int(fields.pop("donor", -1)),
            ))
            if fields:
                raise ValueError(f"unknown fault fields {sorted(fields)} "
                                 f"in {ev!r}")
            if recover_at is not None:
                faults.append(Fault(kind="recover", step=int(recover_at),
                                    peer=faults[-1].peer))
        return cls(faults=cls._ordered(faults), seed=int(seed))

    @staticmethod
    def _ordered(faults: Sequence[Fault]) -> Tuple[Fault, ...]:
        # stable order: by step, then by original position — replay is
        # deterministic regardless of how the plan was written
        return tuple(sorted(faults, key=lambda f: f.step))

    def at(self, step: int) -> Tuple[Fault, ...]:
        return tuple(f for f in self.faults if f.step == int(step))

    @property
    def empty(self) -> bool:
        return not self.faults

    @property
    def last_step(self) -> int:
        return max((f.step for f in self.faults), default=-1)

    def describe(self) -> str:
        if self.empty:
            return "empty plan (membership on, no faults)"
        return "; ".join(
            f"{f.kind}@{f.step}"
            + (f" peer={f.peer}" if f.kind in ("crash", "nan", "recover")
               else "")
            + (f" group={f.group}" if f.kind in ("nan", "corrupt", "drop")
               else "")
            + (f" {f.seconds:g}s" if f.kind == "hang" else "")
            for f in self.faults)


def as_plan(faults) -> FaultPlan:
    """Coerce ``faults`` (a FaultPlan, a spec string, or None) to a plan."""
    if faults is None:
        return FaultPlan()
    if isinstance(faults, FaultPlan):
        return faults
    if isinstance(faults, str):
        return FaultPlan.parse(faults)
    raise TypeError(f"faults must be a FaultPlan or spec string, "
                    f"got {type(faults).__name__}")
