"""TRPC transport — torch.distributed.rpc (TensorPipe) backend (a copy of
``fedml_tpu/core/distributed/communication/trpc`` but for its stop).

Parity target: reference ``communication/trpc/trpc_comm_manager.py:21``
(``rpc.init_rpc`` :66, ``rpc_sync`` :82 into the peer's message handler).
The wire payload is the same msgpack ``Message`` encoding as TCP/gRPC
(the reference sends pickled objects over RPC; msgpack keeps the payload
engine-neutral and safe), so managers are drop-in interchangeable.

``rpc.init_rpc`` is process-global — exactly one TRPCCommManager per
process (the reference has the same constraint); multi-rank tests therefore
run one rank per spawned process. Coordination uses the torchrun env
contract (MASTER_ADDR/MASTER_PORT).

``stop_receive_message`` shuts the RPC agent down gracefully, as the
reference does (``rpc.shutdown()``; the JAX package's copy shuts down
locally): every rank waits for the others to reach shutdown, so the
reply to a peer's in-flight ``rpc_sync`` (the server's FINISH to the
silo that is stopping) is still sent. A local shutdown right after
handling a message drops that reply and the sender's ``rpc_sync``
fails. Past ``SHUTDOWN_TIMEOUT_S`` (a rank that died) the agent shuts
down locally.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Optional

from ..base_com_manager import BaseCommunicationManager
from ..message import Message

logger = logging.getLogger(__name__)

_WORKER_FMT = "fedml_tpu_worker_{}"
SHUTDOWN_TIMEOUT_S = 60.0

# process-global inbox the RPC target function drops into (rpc functions
# must be module-level importables on the callee)
_INBOX: "queue.Queue[bytes]" = queue.Queue()


def _deliver(blob: bytes) -> bool:
    _INBOX.put(bytes(blob))
    return True


class TRPCCommManager(BaseCommunicationManager):
    def __init__(self, rank: int, world_size: int,
                 master_addr: str = "127.0.0.1",
                 master_port: int = 29500,
                 num_threads: int = 4):
        super().__init__()
        import torch.distributed.rpc as rpc

        self.rank = int(rank)
        self.world_size = int(world_size)
        self._rpc = rpc
        os.environ.setdefault("MASTER_ADDR", master_addr)
        os.environ.setdefault("MASTER_PORT", str(master_port))
        opts = rpc.TensorPipeRpcBackendOptions(num_worker_threads=num_threads)
        rpc.init_rpc(_WORKER_FMT.format(self.rank), rank=self.rank,
                     world_size=self.world_size, rpc_backend_options=opts)
        self._running = False
        logger.info("trpc rank %d/%d up", self.rank, self.world_size)

    def send_message(self, msg: Message) -> None:
        dst = _WORKER_FMT.format(int(msg.get_receiver_id()))
        self._rpc.rpc_sync(dst, _deliver, args=(msg.encode(),))

    def handle_receive_message(self) -> None:
        self._running = True
        while self._running:
            try:
                blob = _INBOX.get(timeout=0.2)
            except queue.Empty:
                continue
            self.notify(Message.decode(blob))

    def stop_receive_message(self) -> None:
        self._running = False
        try:
            self._rpc.shutdown(graceful=True, timeout=SHUTDOWN_TIMEOUT_S)
            return
        except Exception as e:  # noqa: BLE001 — a peer never arrived
            logger.warning("trpc rank %d: graceful shutdown failed (%s); "
                           "shutting down locally", self.rank, e)
        try:
            self._rpc.shutdown(graceful=False)
        except Exception:  # noqa: BLE001 — already down
            pass
