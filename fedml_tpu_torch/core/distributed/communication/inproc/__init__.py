"""In-process broker transport — queues between threads in one process (a
copy of ``fedml_tpu/core/distributed/communication/inproc``).

It runs cross-silo protocol tests and benches without a cluster: every
rank is a thread and the broker routes encoded Messages between per-rank
queues. Messages are encode/decode round-tripped so the wire path is
exercised identically to TCP/gRPC.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict

from ..base_com_manager import BaseCommunicationManager
from ..message import Message


class InProcBroker:
    """Shared router: one inbox per rank. Create one per simulated run."""

    def __init__(self):
        self._inboxes: Dict[int, "queue.Queue[bytes]"] = {}
        self._lock = threading.Lock()

    def inbox(self, rank: int) -> "queue.Queue[bytes]":
        with self._lock:
            return self._inboxes.setdefault(int(rank), queue.Queue())

    def post(self, rank: int, blob: bytes) -> None:
        self.inbox(rank).put(blob)


class InProcCommManager(BaseCommunicationManager):
    def __init__(self, broker: InProcBroker, rank: int):
        super().__init__()
        self.broker = broker
        self.rank = int(rank)
        self._running = False

    def send_message(self, msg: Message) -> None:
        self.broker.post(msg.get_receiver_id(), msg.encode())

    def handle_receive_message(self) -> None:
        self._running = True
        inbox = self.broker.inbox(self.rank)
        while self._running:
            try:
                blob = inbox.get(timeout=0.1)
            except queue.Empty:
                continue
            self.notify(Message.decode(blob))

    def stop_receive_message(self) -> None:
        self._running = False
