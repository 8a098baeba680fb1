"""In-process serving fleet on one card: 1 replica against 3, and 3 with a
CUDA stream of its own for each engine thread.

    python scripts/fleet_scaling.py [--switch-interval S]
                                    [--configs 1_replica,3_replicas]

Each configuration serves the same seeded multi-turn load at c64
(``chip_smoke.FLEET_LOAD`` cut to 8 sessions per tenant: 192 requests,
``scripts/serving_load_torch.py``; ``chip_smoke.py``'s fleet_off leg:
round-robin routing, the prompt prefix cache, 4 % connection drops, no
replica loss) on the FedLLM main path's model at seq 1024
(``chip_smoke.fleet_soak``). Besides the leg's tokens/s and TTFT it
reports, per replica, decode steps per second and the share of the wall
its engine thread spent inside ``DecodeScheduler.step`` (host clock; the
step ends in its one device-to-host copy). If three replicas each step a
third as often as one, and each is busy a third of the time, they take
turns: one process, one GIL, one default stream. The stream variant
runs every engine thread under its own ``torch.cuda.Stream``; the
scheduler's pools and parameters are made before the threads start and
are only read or written in place from them. ``--switch-interval``
sets the interpreter's thread switch interval (``sys.setswitchinterval``,
5 ms by default): if the replicas wait on each other for the
interpreter, a shorter interval changes their step times. Prints one
JSON line per configuration, then the card (``nvidia-smi`` name, power
limit).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

# label -> (replicas, a CUDA stream per engine thread)
CONFIGS = {"1_replica": (1, False), "3_replicas": (3, False),
           "3_replicas_own_streams": (3, True)}
LOAD = dict(cs.FLEET_LOAD, sessions_per_tenant=8)
CONCURRENCY = 64


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--switch-interval", type=float,
                    default=sys.getswitchinterval())
    ap.add_argument("--configs", default=",".join(CONFIGS),
                    help="comma-separated subset of " + ", ".join(CONFIGS))
    opts = ap.parse_args()
    sys.setswitchinterval(opts.switch_interval)
    import torch
    if not torch.cuda.is_available():
        print("fleet_scaling: no CUDA device", file=sys.stderr)
        return 1
    from fedml_tpu_torch import llm
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.serving.batch import engine as eng_mod
    from fedml_tpu_torch.serving.batch import scheduler as sched_mod

    busy = {}
    lock = threading.Lock()
    plain_step = sched_mod.DecodeScheduler.step

    def timed_step(self):
        t0 = time.perf_counter()
        try:
            return plain_step(self)
        finally:
            with lock:
                busy[id(self)] = busy.get(id(self), 0.0) + (
                    time.perf_counter() - t0)

    sched_mod.DecodeScheduler.step = timed_step
    plain_loop = eng_mod.BatchingEngine._loop

    def stream_loop(self):
        with torch.cuda.stream(torch.cuda.Stream()):
            plain_loop(self)

    model = cs.fleet_model(torch, llm, Arguments)
    for label in opts.configs.split(","):
        replicas, per_stream = CONFIGS[label]
        eng_mod.BatchingEngine._loop = stream_loop if per_stream \
            else plain_loop
        busy.clear()
        seen = []
        plain_init = sched_mod.DecodeScheduler.__init__

        def init(self, *a, **k):
            plain_init(self, *a, **k)
            seen.append(self)

        sched_mod.DecodeScheduler.__init__ = init
        try:
            leg = cs.fleet_soak(torch, model, False, LOAD,
                                replicas=replicas, conc=CONCURRENCY,
                                loss_at=None)
        finally:
            sched_mod.DecodeScheduler.__init__ = plain_init
        wall = leg["wall_s"]
        leg["per_replica"] = [
            {"steps_per_s": s.steps_run / wall,
             "step_busy_share": busy.get(id(s), 0.0) / wall}
            for s in seen if s.steps_run]
        print(json.dumps({"fleet_scaling": label, "replicas": replicas,
                          "own_streams": per_stream, "load": LOAD,
                          "switch_interval_s": sys.getswitchinterval(),
                          "concurrency": CONCURRENCY, **leg}),
              flush=True)
    print(f"card: {cs.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
