#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 8 (c) benches (``bench_robust_krum``,
``bench_robust_rfa`` at their own configuration) on one CUDA card, each leg
in turn and twice, with where a block's time goes.

    python3 scripts/robust_bench_profile.py [rounds]

Per bench and leg (the fused path, ``robust_fused: auto``, and the host
path, ``host``), in the order fused, host, host, fused: a warm-up block of
8 rounds, then ``rounds`` (default 16) timed in blocks of 8, seconds per
round; then one block under ``torch.profiler`` (CPU and CUDA), its device
busy time, and the host-side CUDA calls that wait (stream and device
synchronisations, copies, pinned allocations) with their counts and CPU
milliseconds. Prints one JSON line per leg, then the card.
"""
import json, os, sys, time
root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.chdir(root)
sys.path.insert(0, root)
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as c
from fedml_tpu_torch.core.algframe.types import TrainHyper

BLOCK = c.ROBUST_BENCH_BLOCK
ROUNDS = int(sys.argv[1]) if len(sys.argv) > 1 else 16
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync",
         "cudaMemcpy", "cudaHostAlloc", "cudaEventSynchronize",
         "cudaStreamWaitEvent", "cudaEventQuery", "cudaLaunchKernel",
         "cudaGraphLaunch")


def leg(metric, kw, mode):
    sim = c.robust_simulator(dict(c.ROBUST_BENCH, robust_fused=mode, **kw))
    hyper = TrainHyper(learning_rate=c.ROBUST_BENCH["learning_rate"])
    sim.run_rounds_fused(0, BLOCK, hyper)
    torch.cuda.synchronize()
    r, t0 = BLOCK, time.perf_counter()
    while r < BLOCK + ROUNDS:
        sim.run_rounds_fused(r, BLOCK, hyper)
        r += BLOCK
    torch.cuda.synchronize()
    round_s = (time.perf_counter() - t0) / ROUNDS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.run_rounds_fused(r, BLOCK, hyper)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in ev
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    waits = {e.key: [e.count, e.cpu_time_total / 1e3] for e in ev
             if e.key in WAITS}
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
    return {"bench": metric, "leg": mode, "round_s": round_s,
            "device_busy_ms_per_round": busy_us / 1e3 / BLOCK,
            "cuda_calls_per_block": waits,
            "top_device_ms_per_block": {e.key[:60]: e.self_device_time_total
                                        / 1e3 for e in top}}


torch.backends.cuda.matmul.allow_tf32 = False
for metric, kw in c.ROBUST_BENCHES.items():
    for mode in ("auto", "host", "host", "auto"):
        print(json.dumps(leg(metric, kw, mode)), flush=True)
print(f"card: {c.card_line()}")
