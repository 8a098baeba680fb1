"""Client diagnosis: loopback echo checks of the comm backends
(counterpart of ``fedml_tpu/utils/diagnosis.py``).

Parity target: reference ``computing/scheduler/slave/client_diagnosis.py:24``
(connectivity probes to MQTT/S3/platform + client↔server echo test). This
framework is local-first, so diagnosis probes what actually carries traffic
here: the gRPC and TCP WAN transports (send → receive round-trip on
loopback) and the device runtime: a torch op on the run's device (the card
unless ``device="cpu"``; no card is a FAIL naming it, never a quiet probe
of the CPU). gRPC needs ``grpcio``; where it is absent the ``grpc`` line
reports FAIL with the import error.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

GRPC_DIAG_PORT = 39790
TCP_DIAG_PORT = 39890


def _echo_backend(make_manager) -> Tuple[bool, str]:
    import threading

    from ..core.distributed.communication.base_com_manager import Observer
    from ..core.distributed.communication.message import Message

    class _Sink(Observer):
        def __init__(self):
            self.got = threading.Event()

        def receive_message(self, msg_type, msg):
            self.got.set()

    a = b = None
    try:
        a = make_manager(0)
        b = make_manager(1)
        sink = _Sink()
        b.add_observer(sink)
        threading.Thread(target=b.handle_receive_message,
                         daemon=True).start()
        msg = Message("diag_echo", 0, 1)
        msg.add_params("payload", [1, 2, 3])
        t0 = time.perf_counter()
        a.send_message(msg)
        if not sink.got.wait(timeout=5.0):
            return False, "no message within 5s"
        ms = (time.perf_counter() - t0) * 1e3
        return True, f"echo round-trip {ms:.1f} ms"
    except Exception as e:  # noqa: BLE001 — diagnosis must report, not die
        return False, str(e)
    finally:
        for m in (a, b):
            try:
                if m is not None:
                    m.stop_receive_message()
            except Exception:
                pass


def _probe_device(device) -> Tuple[bool, str]:
    """``(x * x).sum()`` of ``arange(8.)`` on ``get_device(device)``."""
    try:
        import torch

        from ..device import get_device
        dev = get_device(device)
        x = torch.arange(8.0, device=dev)
        val = float((x * x).sum())
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        return val == 140.0, f"{dev}: {name}"
    except Exception as e:  # noqa: BLE001
        return False, str(e)


def run_diagnosis(device=None, grpc_port: int = GRPC_DIAG_PORT,
                  tcp_port: int = TCP_DIAG_PORT
                  ) -> Dict[str, Tuple[bool, str]]:
    report: Dict[str, Tuple[bool, str]] = {"device": _probe_device(device)}

    from ..core.distributed.communication.grpc import GRPCCommManager
    from ..core.distributed.communication.tcp import TCPCommManager

    report["grpc"] = _echo_backend(
        lambda rank: GRPCCommManager(rank, base_port=grpc_port))
    report["tcp"] = _echo_backend(
        lambda rank: TCPCommManager(rank, base_port=tcp_port))
    return report


if __name__ == "__main__":
    for name, (ok, detail) in run_diagnosis().items():
        print(f"{name:<10} {'OK' if ok else 'FAIL'}  {detail}")
