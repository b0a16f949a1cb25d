"""Per-round plane checksum guard for the gossip wire (port of
``repro/chaos/guard.py``).

:class:`WireGuard` models the integrity protocol at the round boundary: the
sender *seals* each outgoing group buffer with a CRC32 over its raw bytes
and keeps the pristine buffer as a resend cache; the receiver verifies the
checksum and, on mismatch (corrupt) or a missing payload (drop), rejects
the delivery and requests a resend, substituting the sender's sealed copy.
Because the repaired payload IS the sealed original, a guarded round is
bit-exact with an unguarded fault-free round by construction; what the
guard adds is *detection* (``checksum_rejects`` / ``drops_detected`` /
``resends`` counters surfaced in ``summary()``) and a bounded time to
detect of one round.

The ring hop on one card has no per-payload host hook, so the guard runs
on the materialized plane at the step boundary where the chaos controller
injects wire faults (DESIGN.md §15). A tensor's bytes reach ``zlib.crc32``
unchanged, through a ``uint8`` view of a host copy, bfloat16 included
(which numpy cannot hold): the CRC of a group equals the reference's CRC
of the same values.
"""
from __future__ import annotations

import zlib
from typing import Dict, Optional, Tuple

import torch


def buffer_checksum(buf: torch.Tensor) -> int:
    """CRC32 over a tensor's raw bytes, in the memory order of a contiguous
    copy (a host copy for a device tensor)."""
    t = buf.detach().reshape(-1).contiguous().cpu()
    return zlib.crc32(t.view(torch.uint8).numpy())


def plane_checksum(plane: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """Per-group CRC32 of a flat plane (the unit the wire ships)."""
    return {name: buffer_checksum(buf) for name, buf in plane.items()}


def _damaged_copy(buf: torch.Tensor) -> torch.Tensor:
    """The in-transit copy of ``buf`` with byte 0 flipped (a host copy)."""
    damaged = buf.detach().reshape(-1).cpu().clone()
    damaged.view(torch.uint8)[0] ^= 0xFF
    return damaged


class WireGuard:
    """Seal / verify / resend protocol for one plane per round."""

    def __init__(self):
        self.rounds_sealed = 0
        self.checksum_rejects = 0
        self.drops_detected = 0
        self.resends = 0

    def seal(self, plane: Dict[str, torch.Tensor]) -> Dict[str, int]:
        """Checksum every outgoing group buffer (the resend cache is the
        plane itself: the caller keeps the handles alive)."""
        self.rounds_sealed += 1
        return plane_checksum(plane)

    def verify(self, seals: Dict[str, int], name: str,
               payload: Optional[torch.Tensor]) -> bool:
        """True iff ``payload`` arrived and matches its seal."""
        if payload is None:
            return False
        return buffer_checksum(payload) == seals[name]

    def round_trip(self, plane: Dict[str, torch.Tensor], *,
                   corrupt_group: Optional[str] = None,
                   drop_group: Optional[str] = None
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
        """One guarded wire round with optional injected faults.

        Seals ``plane``, damages the in-transit copy of the named groups
        (byte flip for ``corrupt_group``, absence for ``drop_group``),
        verifies on receive, and repairs every rejected payload from the
        sealed pristine buffer. Returns ``(delivered, events)`` where
        ``delivered`` holds ``plane``'s own buffers (repair == resend of the
        original, so the device handles are kept) and ``events`` records
        what the guard saw per group (``"ok"`` / ``"checksum-reject"`` /
        ``"drop"``)."""
        seals = self.seal(plane)
        delivered: Dict[str, torch.Tensor] = {}
        events: Dict[str, str] = {}
        for name, buf in plane.items():
            wire: Optional[torch.Tensor] = buf
            if name == drop_group:
                wire = None
            elif name == corrupt_group:
                wire = _damaged_copy(buf)
            if self.verify(seals, name, wire):
                events[name] = "ok"
                delivered[name] = buf  # verified: keep the device handle
                continue
            if wire is None:
                self.drops_detected += 1
                events[name] = "drop"
            else:
                self.checksum_rejects += 1
                events[name] = "checksum-reject"
            self.resends += 1
            delivered[name] = buf  # resend: the sealed pristine buffer
        return delivered, events

    def counters(self) -> Dict[str, int]:
        return {"rounds_sealed": self.rounds_sealed,
                "checksum_rejects": self.checksum_rejects,
                "drops_detected": self.drops_detected,
                "resends": self.resends}
