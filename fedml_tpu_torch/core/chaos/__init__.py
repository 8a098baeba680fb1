"""Chaos subsystem: deterministic fault injection (counterpart of
``fedml_tpu/core/chaos``, as far as the simulators and the serving plane
use it).

``FaultPlan`` is the seeded schedule (dropout / stragglers / link faults /
crash-at-round / serving stalls, NaN poison, connection drops and replica
crashes), ``FaultLedger`` the injected-vs-observed accounting, mirrored to
the obs sink, and ``ServingChaosInjector`` the serving plane's interceptor
(the batch engine's decode loop, the gateway's connect, the replica's
request seam), and ``ChaosCommManager`` the transport interceptor (link
loss, duplication and delay at the ``Message`` send seam). Everything is
OFF by default: with the ``chaos_*`` knobs at their defaults the rounds,
the cross-silo wire and the decode loop are unchanged.
"""

from .interceptor import ChaosCommManager
from .plan import (ChaosCrash, FaultLedger, FaultPlan, LinkDecision,
                   RoundFaults)
from .serving import ServingChaosInjector

__all__ = ["ChaosCommManager", "ChaosCrash", "FaultLedger", "FaultPlan",
           "LinkDecision", "RoundFaults", "ServingChaosInjector"]
