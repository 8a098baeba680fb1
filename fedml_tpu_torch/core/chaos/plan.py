"""Deterministic fault injection — the chaos subsystem's schedule (a copy
of ``fedml_tpu/core/chaos/plan.py``; its ledger records go through the
obs sink, ``core/obs/sink.py``, which ``mlops`` shares, as ``kind:
chaos``).

Real federated deployments (the reference's Octopus/Beehive pillars) live
with client dropout, stragglers, flaky links, and mid-run crashes; the
literature treats partial participation and straggler tolerance as
first-class (FedAvg's client sampling, FedProx-style partial local work).
A robustness claim that cannot be *tested* is a hope, not a property — so
every fault here is drawn from a seeded, stateless schedule: the same
``chaos_seed`` reproduces the same dropout/straggler/crash trace in any
process, in any order of queries, which is what makes crash-resume and
tolerance tests assertable instead of flaky.

Statelessness is the load-bearing design decision: each decision is a pure
function of ``(seed, kind, round_idx, client_id)`` via a fresh
``np.random.Generator`` seeded with that tuple (SeedSequence hashing is
platform-stable). Server and client processes holding the same args agree
on the plan without any coordination, and the injected-vs-observed ledger
can be reconciled after the fact.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# domain-separation tags for the per-decision PRNG streams (arbitrary
# distinct ints; folded into the SeedSequence entropy tuple)
_TAG_DROP = 11
_TAG_STRAGGLE = 13
_TAG_LINK = 17
_TAG_SERVE_STEP = 19    # per-decode-step engine faults (stall / NaN)
_TAG_SERVE_GW = 23      # per-request gateway->replica connection drops


def _none_or_int(v: Any) -> Optional[int]:
    # NOT `v in (None, "", False)`: 0 == False in Python, and step/request
    # index 0 is a legal fault position (crash on the FIRST request)
    if v is None or v == "" or v is False:
        return None
    return int(v)


class ChaosCrash(RuntimeError):
    """Injected crash-at-round event. Raised by the engine AFTER the round
    (and its checkpoint, when due) completes — the crash-resume e2e path:
    catch it, re-run, and the ``RoundCheckpointer`` restores the trajectory.
    """

    def __init__(self, round_idx: int):
        super().__init__(f"chaos: injected crash at round {round_idx}")
        self.round_idx = int(round_idx)


@dataclass(frozen=True)
class RoundFaults:
    """The plan's verdict for one round over a candidate client set."""

    round_idx: int
    dropped: Tuple[int, ...]                 # client ids that never report
    work_scale: Dict[int, float] = field(default_factory=dict)
    # client id -> fraction of local work a straggler completes (absent =
    # full work; dropped clients are NOT also listed as stragglers)

    def scale_for(self, client_id: int) -> float:
        if client_id in self.dropped:
            return 0.0
        return float(self.work_scale.get(client_id, 1.0))


@dataclass(frozen=True)
class LinkDecision:
    """Fault verdict for one message on a link: how many copies to deliver
    (0 = loss, 2 = duplication) after an optional delay."""

    copies: int = 1
    delay_s: float = 0.0

    @property
    def faulty(self) -> bool:
        return self.copies != 1 or self.delay_s > 0.0


class FaultPlan:
    """Seeded schedule of per-round client dropouts, straggler slowdowns
    (reduced local-step fractions), link loss/duplication/delay, and
    crash-at-round events. All knobs default to OFF: a default-constructed
    plan is ``enabled == False`` and injects nothing."""

    def __init__(self, seed: int = 0, dropout_prob: float = 0.0,
                 straggler_prob: float = 0.0, straggler_work: float = 0.5,
                 link_loss_prob: float = 0.0, link_dup_prob: float = 0.0,
                 link_delay_prob: float = 0.0, link_delay_s: float = 0.0,
                 crash_at_round: Optional[int] = None,
                 serving_stall_prob: float = 0.0,
                 serving_stall_s: float = 0.0,
                 serving_stall_at_step: Optional[int] = None,
                 serving_nan_prob: float = 0.0,
                 serving_nan_at_step: Optional[int] = None,
                 serving_conn_drop_prob: float = 0.0,
                 serving_crash_at_request: Optional[int] = None):
        def _opt(v):
            return None if v is None or int(v) < 0 else int(v)

        self.seed = int(seed)
        self.dropout_prob = float(dropout_prob)
        self.straggler_prob = float(straggler_prob)
        self.straggler_work = min(max(float(straggler_work), 0.0), 1.0)
        self.link_loss_prob = float(link_loss_prob)
        self.link_dup_prob = float(link_dup_prob)
        self.link_delay_prob = float(link_delay_prob)
        self.link_delay_s = max(float(link_delay_s), 0.0)
        self.crash_at_round = _opt(crash_at_round)
        # serving fault kinds (the serving plane's analogue of link
        # faults): injected decode stalls, NaN-logit poison, gateway->
        # replica connection drops, and replica crash-at-request-N. Every
        # decision is a pure function of (seed, kind, index); the *_at_*
        # forms are the deterministic single-shot variants tests pin.
        self.serving_stall_prob = float(serving_stall_prob)
        self.serving_stall_s = max(float(serving_stall_s), 0.0)
        self.serving_stall_at_step = _opt(serving_stall_at_step)
        self.serving_nan_prob = float(serving_nan_prob)
        self.serving_nan_at_step = _opt(serving_nan_at_step)
        self.serving_conn_drop_prob = float(serving_conn_drop_prob)
        self.serving_crash_at_request = _opt(serving_crash_at_request)

    @classmethod
    def from_args(cls, args) -> "FaultPlan":
        """Build from the ``chaos_*`` knobs in ``arguments.py`` (all off by
        default). ``chaos_seed`` falls back to ``random_seed`` so a seeded
        run's faults are reproducible without an extra knob."""
        seed = getattr(args, "chaos_seed", None)
        if seed is None:
            seed = getattr(args, "random_seed", 0)
        return cls(
            seed=int(seed),
            dropout_prob=float(getattr(args, "chaos_dropout_prob", 0.0)
                               or 0.0),
            straggler_prob=float(getattr(args, "chaos_straggler_prob", 0.0)
                                 or 0.0),
            straggler_work=float(getattr(args, "chaos_straggler_work", 0.5)
                                 or 0.5),
            link_loss_prob=float(getattr(args, "chaos_link_loss_prob", 0.0)
                                 or 0.0),
            link_dup_prob=float(getattr(args, "chaos_link_dup_prob", 0.0)
                                or 0.0),
            link_delay_prob=float(getattr(args, "chaos_link_delay_prob", 0.0)
                                  or 0.0),
            link_delay_s=float(getattr(args, "chaos_link_delay_s", 0.0)
                               or 0.0),
            crash_at_round=_none_or_int(
                getattr(args, "chaos_crash_at_round", None)),
            serving_stall_prob=float(
                getattr(args, "chaos_serving_stall_prob", 0.0) or 0.0),
            serving_stall_s=float(
                getattr(args, "chaos_serving_stall_s", 0.0) or 0.0),
            serving_stall_at_step=_none_or_int(
                getattr(args, "chaos_serving_stall_at_step", None)),
            serving_nan_prob=float(
                getattr(args, "chaos_serving_nan_prob", 0.0) or 0.0),
            serving_nan_at_step=_none_or_int(
                getattr(args, "chaos_serving_nan_at_step", None)),
            serving_conn_drop_prob=float(
                getattr(args, "chaos_serving_conn_drop_prob", 0.0) or 0.0),
            serving_crash_at_request=_none_or_int(
                getattr(args, "chaos_serving_crash_at_request", None)),
        )

    # --- enablement ---------------------------------------------------------
    @property
    def injects_availability(self) -> bool:
        return self.dropout_prob > 0.0 or self.straggler_prob > 0.0

    @property
    def expected_work_fraction(self) -> float:
        """Mean fraction of its SCHEDULED local work a client actually runs
        under the availability knobs: dropped clients run 0, stragglers
        ``straggler_work``, the rest 1.0. This is what the bench's FLOPs
        costing must scale by — counting full epochs for clients the plan
        drops would overstate MFU under injection."""
        alive = 1.0 - min(max(self.dropout_prob, 0.0), 1.0)
        p_s = min(max(self.straggler_prob, 0.0), 1.0)
        return alive * (1.0 - p_s + p_s * self.straggler_work)

    @property
    def injects_link_faults(self) -> bool:
        return (self.link_loss_prob > 0.0 or self.link_dup_prob > 0.0
                or (self.link_delay_prob > 0.0 and self.link_delay_s > 0.0))

    @property
    def injects_serving_faults(self) -> bool:
        return ((self.serving_stall_prob > 0.0
                 or self.serving_stall_at_step is not None)
                and self.serving_stall_s > 0.0) \
            or self.serving_nan_prob > 0.0 \
            or self.serving_nan_at_step is not None \
            or self.serving_conn_drop_prob > 0.0 \
            or self.serving_crash_at_request is not None

    @property
    def enabled(self) -> bool:
        return (self.injects_availability or self.injects_link_faults
                or self.injects_serving_faults
                or self.crash_at_round is not None)

    # --- per-decision PRNG --------------------------------------------------
    def _rng(self, tag: int, *key: int) -> np.random.Generator:
        # one fresh Generator per decision: stateless, order-independent,
        # identical across processes holding the same seed
        return np.random.default_rng((self.seed, tag) + tuple(
            int(k) & 0x7FFFFFFF for k in key))

    # --- availability faults ------------------------------------------------
    def is_dropped(self, round_idx: int, client_id: int) -> bool:
        if self.dropout_prob <= 0.0:
            return False
        u = self._rng(_TAG_DROP, round_idx, client_id).random()
        return bool(u < self.dropout_prob)

    def work_scale(self, round_idx: int, client_id: int) -> float:
        """Fraction of its local work this client completes this round:
        0.0 = dropped, ``straggler_work`` = straggler, 1.0 = healthy."""
        if self.is_dropped(round_idx, client_id):
            return 0.0
        if self.straggler_prob <= 0.0:
            return 1.0
        u = self._rng(_TAG_STRAGGLE, round_idx, client_id).random()
        return self.straggler_work if u < self.straggler_prob else 1.0

    def round_faults(self, round_idx: int,
                     client_ids: Sequence[int]) -> RoundFaults:
        dropped: List[int] = []
        scales: Dict[int, float] = {}
        for cid in client_ids:
            if self.is_dropped(round_idx, cid):
                dropped.append(int(cid))
                continue
            s = self.work_scale(round_idx, cid)
            if s < 1.0:
                scales[int(cid)] = s
        return RoundFaults(round_idx=int(round_idx),
                           dropped=tuple(dropped), work_scale=scales)

    def trace(self, n_rounds: int,
              client_ids: Sequence[int]) -> List[RoundFaults]:
        """The full deterministic fault trace — what tests assert
        reproduces under the same seed."""
        return [self.round_faults(r, client_ids) for r in range(n_rounds)]

    # --- link faults --------------------------------------------------------
    def link_decision(self, sender: int, receiver: int,
                      seq: int) -> LinkDecision:
        """Fault verdict for the ``seq``-th message this process sends on
        the (sender, receiver) link. Seeded per (link, seq): a rerun with
        the same send order replays the same loss/dup/delay pattern."""
        if not self.injects_link_faults:
            return LinkDecision()
        rng = self._rng(_TAG_LINK, sender, receiver, seq)
        u_loss, u_dup, u_delay = rng.random(3)
        copies = 1
        if self.link_loss_prob > 0.0 and u_loss < self.link_loss_prob:
            copies = 0
        elif self.link_dup_prob > 0.0 and u_dup < self.link_dup_prob:
            copies = 2
        delay = 0.0
        if (copies > 0 and self.link_delay_prob > 0.0
                and self.link_delay_s > 0.0
                and u_delay < self.link_delay_prob):
            delay = self.link_delay_s
        return LinkDecision(copies=copies, delay_s=delay)

    # --- serving faults -----------------------------------------------------
    def serving_decode_fault(self, step_idx: int) -> Optional[str]:
        """Fault verdict for the engine's ``step_idx``-th decode step:
        ``"nan"`` (poisoned logits), ``"stall"`` (the step wedges for
        ``serving_stall_s``), or None. Pure function of (seed, kind,
        step_idx): the same plan replays the same fault trace after any
        engine reset — which is what makes recovery determinism a test
        instead of a hope. NaN wins a tie (a poisoned step is the louder
        failure)."""
        step_idx = int(step_idx)
        if self.serving_nan_at_step is not None \
                and step_idx == self.serving_nan_at_step:
            return "nan"
        if self.serving_stall_at_step is not None \
                and step_idx == self.serving_stall_at_step \
                and self.serving_stall_s > 0.0:
            return "stall"
        if self.serving_nan_prob <= 0.0 and (
                self.serving_stall_prob <= 0.0
                or self.serving_stall_s <= 0.0):
            return None
        u_nan, u_stall = self._rng(_TAG_SERVE_STEP, step_idx).random(2)
        if self.serving_nan_prob > 0.0 and u_nan < self.serving_nan_prob:
            return "nan"
        if (self.serving_stall_prob > 0.0 and self.serving_stall_s > 0.0
                and u_stall < self.serving_stall_prob):
            return "stall"
        return None

    def gateway_drop(self, seq: int) -> bool:
        """True when the ``seq``-th gateway request should see its
        replica connection dropped before any byte reaches a predictor
        (the WAN-flake analogue for the serving wire)."""
        if self.serving_conn_drop_prob <= 0.0:
            return False
        u = self._rng(_TAG_SERVE_GW, seq).random()
        return bool(u < self.serving_conn_drop_prob)

    def serving_crash_due(self, request_idx: int) -> bool:
        """True when the replica should crash on its ``request_idx``-th
        served request (0-based) — the container-kill analogue."""
        return (self.serving_crash_at_request is not None
                and int(request_idx) == self.serving_crash_at_request)

    # --- crash events -------------------------------------------------------
    def crash_due(self, round_idx: int) -> bool:
        return (self.crash_at_round is not None
                and int(round_idx) == self.crash_at_round)

    def __repr__(self) -> str:
        return (f"FaultPlan(seed={self.seed}, drop={self.dropout_prob}, "
                f"straggle={self.straggler_prob}@{self.straggler_work}, "
                f"link=({self.link_loss_prob},{self.link_dup_prob},"
                f"{self.link_delay_prob}x{self.link_delay_s}s), "
                f"crash_at={self.crash_at_round}, "
                f"serving=(stall={self.serving_stall_prob}"
                f"@{self.serving_stall_at_step}x{self.serving_stall_s}s,"
                f"nan={self.serving_nan_prob}@{self.serving_nan_at_step},"
                f"drop={self.serving_conn_drop_prob},"
                f"crash_req={self.serving_crash_at_request}))")


class FaultLedger:
    """Injected-vs-observed fault accounting, one record per round (plus
    link events), mirrored to the obs sink. ``injected`` is what the
    :class:`FaultPlan` scheduled; ``observed`` is what the runtime actually
    saw at the aggregation seam — a tolerance bug shows up as the two
    disagreeing. Buffered-async pours (:meth:`record_pour`), the transport
    interceptor's link faults (:meth:`record_link`) and the serving plane's
    injected faults (:meth:`record_serving`) record here too."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rounds: List[Dict[str, Any]] = []
        self._links: List[Dict[str, Any]] = []
        self._serving: List[Dict[str, Any]] = []

    def record_round(self, round_idx: int, injected: Dict[str, Any],
                     observed: Dict[str, Any]) -> None:
        rec = {"round_idx": int(round_idx), "injected": injected,
               "observed": observed}
        with self._lock:
            self._rounds.append(rec)
        from ..obs import sink
        sink.log_chaos(round_idx=int(round_idx), injected=injected,
                        observed=observed)

    def record_pour(self, version: int, arrivals: List[Dict[str, Any]],
                    observed: Dict[str, Any]) -> None:
        """One buffered-async pour: the per-update arrival records
        (client, staleness at aggregation, arrival timestamp, dispatch
        version) plus what the pour observed (count, leftover buffer,
        staleness cap in force): the arrival distribution a post-mortem
        reconstructs, balanced against the buffer's add/pour counters."""
        rec = {"round_idx": int(version), "pour": True,
               "injected": {"arrivals": list(arrivals)},
               "observed": dict(observed)}
        with self._lock:
            self._rounds.append(rec)
        from ..obs import sink
        sink.log_chaos(round_idx=int(version), arrivals=list(arrivals),
                       observed=dict(observed))

    def record_link(self, sender: int, receiver: int, msg_type: Any,
                    decision: LinkDecision) -> None:
        rec = {"sender": int(sender), "receiver": int(receiver),
               "msg_type": str(msg_type), "copies": decision.copies,
               "delay_s": decision.delay_s}
        with self._lock:
            self._links.append(rec)
        from ..obs import sink
        sink.log_chaos(link=rec)

    def record_serving(self, kind: str, **detail: Any) -> None:
        """One injected serving fault (stall / nan / conn_drop / crash)
        with whatever locates it (step_idx, seq, request_idx). The soak
        test balances these against the engine's observed recoveries —
        an injected fault with no matching reset/failover is a tolerance
        bug."""
        rec = {"kind": str(kind), **detail}
        with self._lock:
            self._serving.append(rec)
        from ..obs import sink
        sink.log_chaos(serving=rec)

    def pours(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [r for r in self._rounds if r.get("pour")]

    def rounds(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._rounds)

    def links(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._links)

    def serving_events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._serving)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"rounds": list(self._rounds), "links": list(self._links),
                    "serving": list(self._serving)}
