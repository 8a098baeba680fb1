"""One cross-silo party as a process of its own.

    python -m fedml_tpu_torch.cross_silo.silo_main <spec.json>

The spec is a JSON object: ``args`` (the session's knobs, ``rank``
among them), ``device`` (``"cuda"`` unless given), ``role`` (``"client"``
unless given) and, for the PUBSUB transports, ``storage_dir``: the object
store's root, shared by every party of the session (it sets
``FEDML_TPU_STORAGE_DIR`` in this process; the broker's address is the
``pubsub_broker_host`` / ``pubsub_broker_port`` knobs). The party joins
the session over its backend (``TCP``, ``GRPC``, ``PUBSUB`` /
``PUBSUB_STORAGE`` / ``MQTT_S3_LOCAL`` or ``TRPC``, one rank per process)
and runs until the session ends, synchronous or ``round_mode:
async_buffered``.

A silo prints, as its last line, one JSON object ``{"silo": {...}}``:
its rank, the local trainings it ran (round, client, steps, host seconds
each), its step programs' captures, warm-up steps and replays, each
counted kernel's launches in this process, the bytes of its model
uploads and the device's peak allocated bytes. The server (``role:
"server"``) writes its final parameters with the wire codec
(``dumps_tree`` of the state dict, on the host) to ``params_out`` when
the spec names one, and prints ``{"server": {...}}``: its history,
final accuracy and ``round_times``.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict


def run_silo(kw: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Run silo ``kw["rank"]`` to the end of the session; returns its
    stats (the ``silo`` record)."""
    import torch

    from .. import cross_silo_runner
    from ..arguments import Arguments
    from ..core.distributed.communication.message import WIRE_STATS
    from ..core.kernels import counted_kernels
    from .message_define import MyMessage

    runner = cross_silo_runner("client", Arguments(**kw), device)
    runner.run()
    trainer = runner.runner.manager.trainer
    stats = {"rank": int(runner.args.rank), "trainings": trainer.log,
             "launches": {fn.__name__: int(fn.launches)
                          for fn in counted_kernels()}}
    stats.update(trainer.program_stats())
    up = WIRE_STATS.snapshot()["by_type"].get(
        str(MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER), {})
    stats["c2s_bytes"] = int(up.get("bytes", 0))
    if trainer.device.type == "cuda":
        stats["peak_allocated_bytes"] = int(torch.cuda.max_memory_allocated(
            trainer.device))
    return stats


def run_server(kw: Dict[str, Any], device="cuda",
               params_out: str = None) -> Dict[str, Any]:
    """Run the session's server to its end; returns the ``server``
    record and writes the final parameters to ``params_out``."""
    from .. import run_cross_silo_server
    from ..core.distributed.communication.message import dumps_tree

    result = run_cross_silo_server(device=device, **kw)
    if params_out:
        with open(params_out, "wb") as f:
            f.write(dumps_tree({k: v.detach().cpu()
                                for k, v in result["params"].items()}))
    return {"history": result["history"],
            "final_test_acc": result["final_test_acc"],
            "round_times": result["round_times"]}


def main(argv) -> int:
    with open(argv[1]) as f:
        spec = json.load(f)
    if spec.get("storage_dir"):
        os.environ["FEDML_TPU_STORAGE_DIR"] = spec["storage_dir"]
    device = spec.get("device", "cuda")
    if spec.get("role", "client") == "server":
        out = {"server": run_server(spec["args"], device,
                                    spec.get("params_out"))}
    else:
        out = {"silo": run_silo(spec["args"], device)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
