"""Chaos interceptor at the ``Message`` send seam (a copy of
``fedml_tpu/core/chaos/interceptor.py``).

Wraps any :class:`BaseCommunicationManager` and consults the
:class:`FaultPlan` per outgoing message: deliver 0 copies (link loss),
2 copies (duplication), or the usual 1, optionally after a delay —
exercising exactly the failure modes a WAN inflicts on the FSMs without
touching any transport. Receive-side behavior is delegated untouched, so
an interceptor-wrapped manager is byte-identical on the wire for every
message the plan leaves alone (and absent link-fault knobs the manager is
never wrapped at all — the default path does not change)."""

from __future__ import annotations

import logging
import threading
from typing import Optional

from ..distributed.communication.base_com_manager import (
    BaseCommunicationManager, Observer)
from ..distributed.communication.message import Message
from .plan import FaultLedger, FaultPlan

logger = logging.getLogger(__name__)


class ChaosCommManager(BaseCommunicationManager):
    """Decorator transport: every ``send_message`` passes through the
    fault plan; everything else forwards to the wrapped manager."""

    def __init__(self, inner: BaseCommunicationManager, plan: FaultPlan,
                 rank: int, ledger: Optional[FaultLedger] = None):
        super().__init__()
        self.inner = inner
        self.plan = plan
        self.rank = int(rank)
        self.ledger = ledger if ledger is not None else FaultLedger()
        self._seq_lock = threading.Lock()
        self._seq: dict = {}   # receiver -> messages sent on that link

    def _next_seq(self, receiver: int) -> int:
        with self._seq_lock:
            n = self._seq.get(receiver, 0)
            self._seq[receiver] = n + 1
            return n

    # --- fault-injecting send ----------------------------------------------
    def send_message(self, msg: Message) -> None:
        receiver = msg.get_receiver_id()
        seq = self._next_seq(receiver)
        decision = self.plan.link_decision(self.rank, receiver, seq)
        if decision.faulty:
            self.ledger.record_link(self.rank, receiver, msg.get_type(),
                                    decision)
            # trace-plane mirror of the ledger entry: the fault lands as
            # an event on whatever span is sending (broadcast, upload),
            # so a dropped/delayed message is visible ON the round's
            # trace instead of only in a separate ledger
            from ..obs import trace as obs_trace
            obs_trace.add_event(
                "chaos.link_fault", link=f"{self.rank}->{receiver}",
                msg_type=str(msg.get_type()), copies=int(decision.copies),
                delay_s=float(decision.delay_s))
        if decision.copies <= 0:
            logger.warning("chaos: dropping message %r on link %d->%s",
                           msg.get_type(), self.rank, receiver)
            return
        if decision.delay_s > 0.0:
            # deliver later from a timer thread — out-of-order arrival is
            # part of the injected fault, exactly like a slow WAN hop
            t = threading.Timer(decision.delay_s, self._deliver,
                                args=(msg, decision.copies))
            t.daemon = True
            t.start()
            return
        # the plain path keeps the wrapped transport's failure surface
        # (retry exhaustion must still raise to the caller); only the
        # injected EXTRA copy downgrades failures to a log line
        self.inner.send_message(msg)
        if decision.copies > 1:
            self._deliver(msg, decision.copies - 1)

    def _deliver(self, msg: Message, copies: int) -> None:
        """Timer-thread / duplicate deliveries: raising here would kill
        nothing useful — log and move on."""
        for _ in range(copies):
            try:
                self.inner.send_message(msg)
            except Exception:
                logger.exception("chaos: delayed/dup delivery failed "
                                 "(link %d->%s)", self.rank,
                                 msg.get_receiver_id())

    # --- delegation ---------------------------------------------------------
    def add_observer(self, observer: Observer) -> None:
        self.inner.add_observer(observer)

    def remove_observer(self, observer: Observer) -> None:
        self.inner.remove_observer(observer)

    def notify(self, msg: Message) -> None:
        self.inner.notify(msg)

    def handle_receive_message(self) -> None:
        self.inner.handle_receive_message()

    def stop_receive_message(self) -> None:
        self.inner.stop_receive_message()
