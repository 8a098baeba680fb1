"""Chaos subsystem: deterministic fault injection (counterpart of
``fedml_tpu/core/chaos``, as far as the simulators use it).

``FaultPlan`` is the seeded schedule (dropout / stragglers / link faults /
crash-at-round) and ``FaultLedger`` the injected-vs-observed accounting,
mirrored to the obs sink. Everything is OFF by default: with the
``chaos_*`` knobs at their defaults the rounds are unchanged. The
transport interceptor (``ChaosCommManager``) waits for the distributed
runtimes, the serving injector for the serving fleet.
"""

from .plan import (ChaosCrash, FaultLedger, FaultPlan, LinkDecision,
                   RoundFaults)

__all__ = ["ChaosCrash", "FaultLedger", "FaultPlan", "LinkDecision",
           "RoundFaults"]
