"""Fault injection and self-healing membership for the decoupled training
step (port of ``repro/chaos``, DESIGN.md §15).

A deterministic :class:`FaultPlan` is replayed by the
:class:`ChaosController` at the host step boundary; a :class:`PeerHealth`
membership state machine is fed by per-peer liveness epochs; the
alive-gated push-sum exchange (``repro_torch.launch.train``) conserves Σw
over the live peer set; a :class:`WireGuard` checksum/resend protocol
guards the gossip wire; and donor-based recovery (:func:`resync_peer`)
re-admits a crashed peer with damped mixing weight.

Enable it end to end with ``make_backend("prod", "layup", ...,
faults=...)``: ``faults`` is a spec string (see
:mod:`repro_torch.chaos.plan`) or a :class:`FaultPlan`; the empty plan
turns the membership machinery on without injecting anything (bit-exact
with the fault-free step).
"""
from repro_torch.chaos.controller import ChaosController
from repro_torch.chaos.guard import WireGuard, buffer_checksum, plane_checksum
from repro_torch.chaos.health import ALIVE, DEAD, SUSPECT, PeerHealth
from repro_torch.chaos.plan import Fault, FaultPlan, as_plan
from repro_torch.chaos.recovery import resync_peer

__all__ = [
    "ALIVE", "SUSPECT", "DEAD",
    "ChaosController", "Fault", "FaultPlan", "PeerHealth", "WireGuard",
    "as_plan", "buffer_checksum", "plane_checksum", "resync_peer",
]
