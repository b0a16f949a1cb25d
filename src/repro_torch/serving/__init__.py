"""Train-and-serve subsystem: live inference from the training read plane
(port of ``repro/serving``).

The decoupled lane's flat parameter plane (DESIGN.md §9/§11) holds one
consistent, fully-materialized buffer at every step boundary. This package
turns it into a weight feed (DESIGN.md §12):

* :class:`PlanePublisher` / :class:`PlaneSnapshot` — once per gossip
  round the trainer publishes a device copy of the read plane plus its
  version clocks and drift metric, with a CUDA event after the copies;
* :class:`SwapPolicy` / :class:`SwapDecision` — staleness/drift/health-
  gated acceptance with min/max swap cadence;
* :class:`AdmissionQueue` / :class:`Ticket` — bounded-depth admission
  control with reject-with-retry-after and per-request deadline drop;
* :class:`LiveServer` — gates snapshots, unpacks accepted planes through
  the training ``FlatPartition`` into a ``ServeLoop`` between decode
  steps, and drives admission → decode → swap-poll.
"""
from repro_torch.serving.live import LiveServer, SwapRecord
from repro_torch.serving.policy import SwapDecision, SwapPolicy
from repro_torch.serving.publisher import PlanePublisher, PlaneSnapshot
from repro_torch.serving.queue import AdmissionQueue, Ticket

__all__ = [
    "AdmissionQueue", "LiveServer", "PlanePublisher", "PlaneSnapshot",
    "SwapDecision", "SwapPolicy", "SwapRecord", "Ticket",
]
