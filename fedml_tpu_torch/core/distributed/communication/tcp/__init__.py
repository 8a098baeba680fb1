"""Raw-TCP transport — length-prefixed msgpack frames, one listener per rank
(a copy of ``fedml_tpu/core/distributed/communication/tcp``).

Parity target: the role of the reference's gRPC backend
(``communication/grpc/grpc_comm_manager.py:30`` — every rank serves on
``base_port + rank``, peers connect ad-hoc to send) with the reference's
1 GB message ceiling replaced by streaming frames. The ip table maps rank ->
host (reference ``ip_config_utils.py`` reads a csv; here a dict or csv path).
"""

from __future__ import annotations

import logging
import queue
import socket
import struct
import threading
from typing import Dict, Optional

from ..base_com_manager import BaseCommunicationManager
from ..message import Message

logger = logging.getLogger(__name__)

TCP_BASE_PORT = 29690  # deliberately distinct from the reference's 8890


def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            return None
        buf += chunk
    return buf


class TCPCommManager(BaseCommunicationManager):
    """Listens on ``base_port + rank``; sends open a short-lived connection
    per message (WAN messages here are round-granularity, so connection
    reuse is not the bottleneck; model payloads stream in 1 MB chunks)."""

    def __init__(self, rank: int, ip_config: Optional[Dict[int, str]] = None,
                 base_port: int = TCP_BASE_PORT, host: str = "127.0.0.1",
                 retry: Optional[dict] = None):
        super().__init__()
        self.rank = int(rank)
        self.ip_config = ip_config or {}
        self.base_port = int(base_port)
        # transport retry policy (exponential backoff + jitter); pre-chaos
        # behavior — fail on the first refused connect — is retry
        # {"max_attempts": 0}
        self.retry = {"max_attempts": 4, "base_s": 0.2, "max_s": 2.0}
        self.retry.update(retry or {})
        self._q: "queue.Queue[bytes]" = queue.Queue()
        self._running = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, self.base_port + self.rank))
        self._srv.listen(64)
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _peer_addr(self, rank: int):
        return (self.ip_config.get(int(rank), "127.0.0.1"),
                self.base_port + int(rank))

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return  # socket closed
            threading.Thread(target=self._recv_one, args=(conn,),
                             daemon=True).start()

    def _recv_one(self, conn: socket.socket) -> None:
        try:
            head = _read_exact(conn, 8)
            if head is None:
                return
            (n,) = struct.unpack("!Q", head)
            blob = _read_exact(conn, n)
            if blob is not None:
                self._q.put(blob)
        finally:
            conn.close()

    def send_message(self, msg: Message) -> None:
        blob = msg.encode()
        addr = self._peer_addr(msg.get_receiver_id())

        def _send_once() -> None:
            with socket.create_connection(addr, timeout=30.0) as s:
                s.sendall(struct.pack("!Q", len(blob)))
                s.sendall(blob)

        from ....obs import trace as obs_trace
        from ..backoff import retry_with_backoff
        # the wire half of the trace: one span per send, backoff retries
        # attached as events — a flapping link shows up ON the round's
        # critical path instead of vanishing into the send call
        with obs_trace.span(
                "comm.send",
                attrs={"transport": "tcp",
                       "receiver": int(msg.get_receiver_id()),
                       "msg_type": str(msg.get_type()),
                       "bytes": len(blob)}) as sp:
            retry_with_backoff(
                _send_once, retry_on=(OSError,),
                describe=f"tcp send {self.rank}->{msg.get_receiver_id()}",
                on_retry=lambda a, d, e: sp.add_event(
                    "retry", attempt=a, delay_s=round(d, 4),
                    error=type(e).__name__),
                **self.retry)

    def handle_receive_message(self) -> None:
        self._running = True
        while self._running:
            try:
                blob = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            self.notify(Message.decode(blob))

    def stop_receive_message(self) -> None:
        self._running = False
        try:
            self._srv.close()
        except OSError:
            pass
