"""The port's TRPC transport (``torch.distributed.rpc``, TensorPipe): an
echo across two spawned single-rank processes, as the JAX package's
``tests/test_trpc.py`` runs it (one manager per process: ``init_rpc`` is
process-global)."""

from __future__ import annotations

import multiprocessing as mp
import os
import sys

import pytest

from test_torch_comm import free_port_base

pytestmark = pytest.mark.torch_port


def _rank_main(rank, port, q):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import threading

    from fedml_tpu_torch.core.distributed.communication.base_com_manager \
        import Observer
    from fedml_tpu_torch.core.distributed.communication.message import \
        Message
    from fedml_tpu_torch.core.distributed.communication.trpc import \
        TRPCCommManager

    mgr = TRPCCommManager(rank, world_size=2, master_addr="127.0.0.1",
                          master_port=port)

    class Sink(Observer):
        def __init__(self):
            self.got = threading.Event()
            self.payload = None

        def receive_message(self, msg_type, msg):
            self.payload = msg.get("payload")
            self.got.set()

    sink = Sink()
    mgr.add_observer(sink)
    threading.Thread(target=mgr.handle_receive_message, daemon=True).start()
    if rank == 0:
        msg = Message("trpc_echo", 0, 1)
        msg.add_params("payload", [4, 5, 6])
        mgr.send_message(msg)
        ok = sink.got.wait(timeout=30)   # rank 1 echoes back
        q.put(("r0", ok, sink.payload))
    else:
        ok = sink.got.wait(timeout=30)
        if ok:
            reply = Message("trpc_echo", 1, 0)
            reply.add_params("payload", sink.payload)
            mgr.send_message(reply)
        q.put(("r1", ok, sink.payload))
    import time
    time.sleep(1.0)
    mgr.stop_receive_message()


def test_trpc_two_process_echo():
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port_base(1)
    procs = [ctx.Process(target=_rank_main, args=(r, port, q))
             for r in (0, 1)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(2):
            name, ok, payload = q.get(timeout=120)
            results[name] = (ok, payload)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
    assert results["r1"] == (True, [4, 5, 6])
    assert results["r0"] == (True, [4, 5, 6])
