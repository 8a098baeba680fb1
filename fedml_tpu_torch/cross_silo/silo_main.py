"""One cross-silo silo as a process of its own.

    python -m fedml_tpu_torch.cross_silo.silo_main <spec.json>

The spec is a JSON object: ``args`` (the session's knobs, ``rank``
among them), ``device`` (``"cuda"`` unless given). The silo joins the
server over the session's backend (``TCP`` or ``GRPC``), trains until the
server finishes the session and prints, as its last line, one JSON
object ``{"silo": {...}}``: its rank, the local trainings it ran (round,
client, steps, host seconds each), its step programs' captures, warm-up
steps and replays, each counted kernel's launches in this process, the
bytes of its model uploads and the device's peak allocated bytes.
"""

from __future__ import annotations

import json
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


def main(argv) -> int:
    with open(argv[1]) as f:
        spec = json.load(f)
    stats = run_silo(spec["args"], spec.get("device", "cuda"))
    print(json.dumps({"silo": stats}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
