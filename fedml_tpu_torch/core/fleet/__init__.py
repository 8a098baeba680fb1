"""Durable multi-tenant fleet plane (Bonawitz MLSys'19 §4 endgame).

* :class:`DeviceRegistry` — sqlite-backed persistent device registry:
  idempotent handshake upserts, participation history, atomic per-round
  claims (one task per device per round), and npz-serialized
  control-plane state snapshots.
* :class:`TaskPlane` / :class:`FleetTask` — N concurrent federated jobs
  (training, analytics, LLM-LoRA) over one registry, sharing one stats
  store, with per-task cohort assembly + pacing and registry-enforced
  fairness caps.
"""

from .plane import FleetTask, TaskPlane
from .registry import DeviceRegistry

__all__ = ["DeviceRegistry", "FleetTask", "TaskPlane"]
