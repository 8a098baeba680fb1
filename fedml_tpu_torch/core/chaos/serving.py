"""Serving-plane chaos: the engine/gateway/replica fault interceptors (a
copy of ``fedml_tpu/core/chaos/serving.py``).

The FL side injects faults at the transport seam (``ChaosCommManager``);
the serving plane's seams are different — the decode loop, the gateway's
connect, and the replica process itself — so this module adapts the same
seeded :class:`FaultPlan` to them. One :class:`ServingChaosInjector`
instance per process holds the plan plus the tiny bit of state the pure
decisions need (which request index this is); every *decision* stays a
pure function of ``(chaos_seed, kind, index)``, so a rerun with the same
plan replays the same fault trace — which is what lets the soak test
assert "every injected fault was recovered from" instead of hoping.

All knobs are OFF by default: a default-constructed plan injects nothing
and the engine/gateway never consult an injector at all (``from_args``
returns None when no serving knob is set).
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, Optional

from .plan import FaultLedger, FaultPlan

logger = logging.getLogger(__name__)


class ServingChaosInjector:
    """Per-process serving fault interceptor over one seeded plan.

    * ``decode_fault(step_idx)`` — the engine consults it before each
      decode step: ``"nan"`` poisons the step's logits flag, ``"stall"``
      wedges the loop for ``stall_s()`` seconds (interruptibly, so the
      watchdog-driven reset can cut the stall short exactly like a
      process restart would);
    * ``connection_drop()`` — the gateway consults it per outgoing
      request; True simulates a refused/reset connect before any byte
      reaches the replica;
    * ``request_crash_due()`` — the replica's HTTP runner consults it per
      served request; with ``hard_crash`` the replica process exits
      (subprocess replicas only), otherwise the connection is severed
      mid-request (the in-process analogue).

    Every injected fault is recorded in the :class:`FaultLedger` so the
    injected-vs-observed reconciliation covers the serving plane too.
    """

    def __init__(self, plan: FaultPlan,
                 ledger: Optional[FaultLedger] = None,
                 hard_crash: bool = False):
        self.plan = plan
        self.ledger = ledger if ledger is not None else FaultLedger()
        self.hard_crash = bool(hard_crash)
        self._lock = threading.Lock()
        self._gw_seq = 0
        self._req_seq = 0

    @classmethod
    def from_args(cls, args,
                  ledger: Optional[FaultLedger] = None,
                  hard_crash: bool = False
                  ) -> Optional["ServingChaosInjector"]:
        """An injector when any ``chaos_serving_*`` knob is live, else
        None — the default path never pays a per-step plan consult."""
        plan = FaultPlan.from_args(args)
        if not plan.injects_serving_faults:
            return None
        return cls(plan, ledger=ledger, hard_crash=hard_crash)

    # ------------------------------------------------------------ engine --
    def decode_fault(self, step_idx: int) -> Optional[str]:
        kind = self.plan.serving_decode_fault(step_idx)
        if kind is not None:
            self.ledger.record_serving(kind, step_idx=int(step_idx))
        return kind

    def stall_s(self) -> float:
        return self.plan.serving_stall_s

    # ----------------------------------------------------------- gateway --
    def connection_drop(self) -> bool:
        """Per-request verdict; the request index is this process's send
        counter, so the drop pattern is fixed for a given send order."""
        with self._lock:
            seq = self._gw_seq
            self._gw_seq += 1
        if self.plan.gateway_drop(seq):
            self.ledger.record_serving("conn_drop", seq=seq)
            return True
        return False

    # ----------------------------------------------------------- replica --
    def request_crash_due(self) -> bool:
        """Counts served requests; True exactly on request N of the
        plan's crash-at-request-N."""
        with self._lock:
            idx = self._req_seq
            self._req_seq += 1
        if self.plan.serving_crash_due(idx):
            self.ledger.record_serving("replica_crash", request_idx=idx,
                                       hard=self.hard_crash)
            return True
        return False

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"gateway_seq": self._gw_seq,
                    "request_seq": self._req_seq,
                    "injected": self.ledger.serving_events()}
