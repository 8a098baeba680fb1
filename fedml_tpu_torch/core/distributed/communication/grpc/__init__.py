"""gRPC transport (a copy of
``fedml_tpu/core/distributed/communication/grpc``, with ``import grpc``
moved into the constructor: the package imports on a host without
``grpcio``, and only a GRPC session needs it).

Parity target: reference ``communication/grpc/grpc_comm_manager.py:30``
(per-rank server on ``base_port + rank``, 1 GB max message, csv ip table).
Differences by design: the wire payload is the msgpack ``Message`` encoding
(not pickle — reference streams pickled objects, which is unsafe), and the
service is registered with grpcio's generic handler API so no protoc-
generated stubs are needed (the reference ships ``*_pb2.py``).
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent import futures
from typing import Dict, Optional

from ..base_com_manager import BaseCommunicationManager
from ..message import Message

logger = logging.getLogger(__name__)

GRPC_BASE_PORT = 29790
_SERVICE = "fedml_tpu.Comm"
_METHOD = "SendMessage"
MAX_MSG = 1024 * 1024 * 1024  # 1 GB, matching reference constants.py:55-57


class GRPCCommManager(BaseCommunicationManager):
    def __init__(self, rank: int, ip_config: Optional[Dict[int, str]] = None,
                 base_port: int = GRPC_BASE_PORT, host: str = "127.0.0.1",
                 retry: Optional[dict] = None):
        import grpc
        self._grpc = grpc
        super().__init__()
        self.rank = int(rank)
        self.ip_config = ip_config or {}
        self.base_port = int(base_port)
        # transport retry policy (exponential backoff + jitter); 0
        # attempts restores the pre-chaos fail-fast behavior
        self.retry = {"max_attempts": 4, "base_s": 0.2, "max_s": 2.0}
        self.retry.update(retry or {})
        self._q: "queue.Queue[bytes]" = queue.Queue()
        self._running = False
        self._channels: Dict[int, "grpc.Channel"] = {}

        def handler(request: bytes, context) -> bytes:
            self._q.put(request)
            return b"ok"

        rpc = grpc.unary_unary_rpc_method_handler(
            handler,
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b)
        generic = grpc.method_handlers_generic_handler(
            _SERVICE, {_METHOD: rpc})
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=8),
            options=[("grpc.max_send_message_length", MAX_MSG),
                     ("grpc.max_receive_message_length", MAX_MSG)])
        self._server.add_generic_rpc_handlers((generic,))
        self._server.add_insecure_port(f"{host}:{self.base_port + self.rank}")
        self._server.start()

    def _stub(self, rank: int):
        rank = int(rank)
        if rank not in self._channels:
            addr = (f"{self.ip_config.get(rank, '127.0.0.1')}:"
                    f"{self.base_port + rank}")
            self._channels[rank] = self._grpc.insecure_channel(
                addr, options=[("grpc.max_send_message_length", MAX_MSG),
                               ("grpc.max_receive_message_length", MAX_MSG)])
        ch = self._channels[rank]
        return ch.unary_unary(f"/{_SERVICE}/{_METHOD}",
                              request_serializer=lambda b: b,
                              response_deserializer=lambda b: b)

    def send_message(self, msg: Message) -> None:
        blob = msg.encode()
        stub = self._stub(msg.get_receiver_id())
        from ....obs import trace as obs_trace
        from ..backoff import retry_with_backoff
        # one span per send with backoff retries as events (see the TCP
        # manager — identical instrumentation, different transport label)
        with obs_trace.span(
                "comm.send",
                attrs={"transport": "grpc",
                       "receiver": int(msg.get_receiver_id()),
                       "msg_type": str(msg.get_type()),
                       "bytes": len(blob)}) as sp:
            retry_with_backoff(
                lambda: stub(blob, timeout=60.0),
                retry_on=(self._grpc.RpcError,),
                describe=f"grpc send {self.rank}->{msg.get_receiver_id()}",
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
        self._server.stop(grace=0.5)
        for ch in self._channels.values():
            ch.close()
