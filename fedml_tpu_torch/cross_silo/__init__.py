"""Cross-silo runtimes (counterpart of ``fedml_tpu/cross_silo``): the
horizontal FedAvg server (synchronous, or buffered-async under
``round_mode: async_buffered``) and silo FSMs, serverless gossip
(``decentralized.py``), split learning (``split_learning.py``), vertical
FL (``vertical.py``), the hierarchical scenario (``hierarchical/``) and
secure aggregation (``secagg/``: SA, ``lightsecagg/``: LSA; both need the
``cryptography`` package), all over the same comm stack (in-proc, TCP,
gRPC, pub/sub with its object store, TRPC)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional


def run_inproc_session(args, build_managers: Callable[[], List[Any]],
                       join_timeout_s: float = 60.0) -> Optional[Dict]:
    """Run a whole multi-party session as threads over the in-proc broker:
    the exact distributed FSM of a TCP/gRPC deployment without sockets.
    ``build_managers`` is called AFTER ``args.inproc_broker`` is set and
    returns the managers; the first runs on the calling thread (it owns
    the session result), the rest on daemon threads."""
    import threading

    from ..core.distributed.communication.inproc import InProcBroker
    args.inproc_broker = InProcBroker()
    managers = build_managers()
    threads = [threading.Thread(target=m.run, daemon=True)
               for m in managers[1:]]
    for t in threads:
        t.start()
    managers[0].run()
    for t in threads:
        t.join(timeout=join_timeout_s)
    return getattr(managers[0], "result", None)
