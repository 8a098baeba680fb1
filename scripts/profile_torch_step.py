#!/usr/bin/env python3
"""Where a local SGD step of the port's main path spends its time, on the
card.

    python3 scripts/profile_torch_step.py [--steps 10]

One client's local training at the main path's full width (ResNet-56,
batch 32, synthetic CIFAR-10 shapes, fused conv block), under
``torch.profiler`` after a warm-up: prints the step time (host clock around
work that ends in a synchronize), the device-busy and idle shares of the
unprofiled step, the conv-block kernel's share, and the top kernels by
device time. Needs a CUDA card; imports nothing of JAX or ``fedml_tpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fedml_tpu_torch import prng
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core.algframe.client_trainer import (
        ClassificationTrainer, make_inner_optimizer)
    from fedml_tpu_torch.core.algframe.local_training import run_local_sgd
    from fedml_tpu_torch.core.algframe.types import ClientData, TrainHyper
    from fedml_tpu_torch.model import create

    dev = torch.device("cuda")
    bundle = create(Arguments(model="resnet56", precision="bfloat16",
                              fused_conv_block="pallas"), 10)
    params = bundle.init(torch.Generator().manual_seed(0), dev)
    spec = ClassificationTrainer(bundle.apply)
    gen = torch.Generator().manual_seed(1)
    n = args.steps
    cdata = ClientData(
        x=torch.randn(n, 32, 32, 32, 3, generator=gen),
        y=torch.randint(0, 10, (n, 32), generator=gen),
        mask=torch.ones(n, 32), num_samples=torch.tensor(32.0 * n)).to(dev)
    opt = make_inner_optimizer("sgd", 0.1)
    hyper = TrainHyper(learning_rate=0.1, epochs=1)
    key = prng.PRNGKey(0)
    run_local_sgd(spec, opt, params, cdata, key, hyper)  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    run_local_sgd(spec, opt, params, cdata, key, hyper)
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run_local_sgd(spec, opt, params, cdata, key, hyper)
        torch.cuda.synchronize()
        window_us = (time.time() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side kernel events only: CPU ops also carry the device time of
    # the kernels they launch, and counting both would count it twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    if not events:
        print("profile_torch_step: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    busy = sum(dev_us(e) for e in events)
    busy_step_ms = busy / n / 1e3
    block = sum(dev_us(e) for e in events if "conv_block_kernel" in e.key)
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"step: {step_ms:.2f} ms per local step (ResNet-56, bs 32, bf16, "
          f"fused conv block), unprofiled")
    # one stream, so kernels do not overlap: the card is busy for the sum
    # of their times; the rest of the unprofiled step it waits on the host
    print(f"device busy {busy_step_ms:.2f} ms per step = "
          f"{busy_step_ms / step_ms:.1%} of the unprofiled step, idle "
          f"{1 - busy_step_ms / step_ms:.1%}; {len(events)} kernel names, "
          f"{sum(e.count for e in events) // n} launches per step "
          f"(profiled window {window_us / 1e3 / n:.1f} ms per step)")
    print(f"conv_block kernel: {block / n / 1e3:.3f} ms per step "
          f"({block / busy:.1%} of device time)")
    print("top kernels by device time (ms per step, share of device time):")
    for e in sorted(events, key=dev_us, reverse=True)[:15]:
        print(f"  {dev_us(e) / n / 1e3:8.3f}  {dev_us(e) / busy:6.1%}  "
              f"x{e.count // n:<4d} {e.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
