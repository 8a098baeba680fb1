#!/usr/bin/env python3
"""Where a local SGD step of the port's main paths spends its time, on the
card.

    python3 scripts/profile_torch_step.py [--model resnet56|llm|llm_hot|serve]
                                          [--steps 10]

One client's local training at a main path's full width, under
``torch.profiler`` after a warm-up:

* ``resnet56`` (default): ResNet-56, batch 32, synthetic CIFAR-10 shapes,
  bf16, fused conv block (B1);
* ``llm``: the FedLLM round's causal LM (``bench.py``'s
  ``bench_federated_lora``: d 512, 4 layers, 8 heads, seq 256, bf16, LoRA
  r8 on q/k/v/o/gate/up/down, flash attention B2-B4), batch 8 of the
  bundled Shakespeare corpus;
* ``llm_hot``: the FedLLM hot loop, ``chip_smoke.py``'s ``HOT_LOOP`` (the
  ~111M causal LM: d 1024, 8 layers, 8 heads of 128, bf16, flash
  attention) at bs 8 x seq 1024 on seeded random tokens, full-parameter
  SGD;
* ``serve``: one decode step of the serving path at ``chip_smoke.py``'s
  serving width (the FedLLM causal LM, bf16, 64 slots all active, paged
  KV cache in blocks of 16, a bank of 64 seeded adapters, every slot on
  its own), then one 32-token prefill chunk; ``cached_attention``'s share
  of the device time besides the rest.

Prints the step time (host clock around work that ends in a synchronize),
the device-busy and idle shares of the unprofiled step, launches per
step, the port's own kernels' share, and the top kernels by device time.
Needs a CUDA card; imports nothing of JAX or ``fedml_tpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--model", choices=("resnet56", "llm", "llm_hot",
                                        "serve"), default="resnet56")
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
    n = args.steps
    if args.model == "serve":
        return profile_serve(torch, n, dev)
    gen = torch.Generator().manual_seed(1)
    if args.model == "resnet56":
        bundle = create(Arguments(model="resnet56", precision="bfloat16",
                                  fused_conv_block="pallas"), 10)
        params = bundle.init(torch.Generator().manual_seed(0), dev)
        spec = ClassificationTrainer(bundle.apply)
        cdata = ClientData(
            x=torch.randn(n, 32, 32, 32, 3, generator=gen),
            y=torch.randint(0, 10, (n, 32), generator=gen),
            mask=torch.ones(n, 32), num_samples=torch.tensor(32.0 * n)).to(dev)
        opt = make_inner_optimizer("sgd", 0.1)
        label = "ResNet-56, bs 32, bf16, fused conv block"
        ours = ("conv_block_mma_kernel",)
    elif args.model == "llm_hot":
        from torch.func import functional_call

        from chip_smoke import HOT_BATCH, HOT_LOOP
        from fedml_tpu_torch import llm
        cfg = llm.LLMConfig(**HOT_LOOP)
        model, params = llm.init_llm(cfg, torch.Generator().manual_seed(0))
        model.to(dev)
        params = {k: v.to(dev) for k, v in params.items()}
        spec = llm.CausalLMTrainer(
            lambda p, x, train=False: functional_call(model, p, (x,)))
        shape = (n, HOT_BATCH, cfg.max_seq_len)
        cdata = ClientData(
            x=torch.randint(0, cfg.vocab_size, shape, generator=gen),
            y=torch.randint(0, cfg.vocab_size, shape, generator=gen),
            mask=torch.ones(n, HOT_BATCH),
            num_samples=torch.tensor(float(n * HOT_BATCH))).to(dev)
        opt = make_inner_optimizer("sgd", 1e-3)
        label = (f"~111M causal LM d{cfg.hidden_size} x{cfg.num_layers} "
                 f"layers, bs {HOT_BATCH} x seq {cfg.max_seq_len}, bf16, "
                 f"full parameters, flash attention")
        ours = ("flash_fwd_mma_kernel", "flash_dq_mma_kernel",
                "flash_dkv_mma_kernel")
    else:
        from fedml_tpu_torch.llm import build_llm
        fed, bundle, spec, _ = build_llm(Arguments(
            dataset="llm", model="causal_lm", precision="bfloat16",
            client_num_in_total=2, batch_size=8, random_seed=0,
            llm_corpus_fallback="shakespeare", llm_hidden_size=512,
            llm_intermediate_size=1408, llm_num_layers=4, llm_num_heads=8,
            llm_max_seq_len=256, lora_rank=8, llm_attention_impl="flash"))
        params = bundle.init(torch.Generator().manual_seed(0), dev)
        silo = fed.train.client(0)
        real = int((silo.mask > 0).any(axis=1).sum())
        reps = -(-n // real)   # the silo's real batches, repeated to n
        cdata = ClientData(
            x=torch.from_numpy(silo.x[:real]).repeat(reps, 1, 1)[:n],
            y=torch.from_numpy(silo.y[:real]).repeat(reps, 1, 1)[:n],
            mask=torch.from_numpy(silo.mask[:real]).repeat(reps, 1)[:n],
            num_samples=torch.tensor(float(silo.num_samples))).to(dev)
        opt = make_inner_optimizer("sgd", 1e-3)
        label = ("FedLLM causal LM d512 x4 layers, bs 8 x seq 256, bf16, "
                 "LoRA r8, flash attention")
        # bf16: B2-B4 on the tensor cores
        ours = ("flash_fwd_mma_kernel", "flash_dq_mma_kernel",
                "flash_dkv_mma_kernel")
    hyper = TrainHyper(learning_rate=opt.lr, epochs=1)
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

    events = device_events(prof, DeviceType)
    if not events:
        print("profile_torch_step: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    busy = sum(_dev_us(e) for e in events)
    busy_step_ms = busy / n / 1e3
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"step: {step_ms:.2f} ms per local step ({label}), unprofiled")
    # one stream, so kernels do not overlap: the card is busy for the sum
    # of their times; the rest of the unprofiled step it waits on the host
    print(f"device busy {busy_step_ms:.2f} ms per step = "
          f"{busy_step_ms / step_ms:.1%} of the unprofiled step, idle "
          f"{1 - busy_step_ms / step_ms:.1%}; {len(events)} kernel names, "
          f"{sum(e.count for e in events) // n} launches per step "
          f"(profiled window {window_us / 1e3 / n:.1f} ms per step)")
    for name in ours:
        mine = [e for e in events if name in e.key]
        t = sum(_dev_us(e) for e in mine)
        print(f"{name}: {t / n / 1e3:.3f} ms per step ({t / busy:.1%} of "
              f"device time), {sum(e.count for e in mine) // n} launches "
              f"per step")
    print("top kernels by device time (ms per step, share of device time):")
    for e in sorted(events, key=_dev_us, reverse=True)[:15]:
        print(f"  {_dev_us(e) / n / 1e3:8.3f}  {_dev_us(e) / busy:6.1%}  "
              f"x{e.count // n:<4d} {e.key[:100]}")
    return 0


def device_events(prof, DeviceType):
    """Device-side kernel events with device time (CPU ops also carry the
    device time of the kernels they launch; counting both would count it
    twice)."""
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _dev_us(e) > 0]


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def profile_serve(torch, n, dev):
    """``n`` decode steps of 64 active slots, then ``n`` 32-token prefill
    chunks, each timed unprofiled and then under the profiler, with
    ``cached_attention`` inside a named range."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from chip_smoke import LLM_MAIN_PATH, SERVE_BATCH, SERVE_PROMPTS
    from fedml_tpu_torch import llm
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.llm import attention
    from fedml_tpu_torch.llm.data import BOS, SEP
    from fedml_tpu_torch.serving.batch import AdapterBank, DecodeScheduler

    plain = attention.cached_attention

    def named(*a):
        with record_function("cached_attention"):
            return plain(*a)

    attention.cached_attention = named   # model.py resolves it per call
    bundle, tok = llm.build_llm_bundle(Arguments(**LLM_MAIN_PATH))
    bundle.to(dev)
    base = bundle.base_params
    gen = torch.Generator().manual_seed(1)
    template = llm.lora_init(gen, base, rank=LLM_MAIN_PATH["lora_rank"])
    bank = AdapterBank(template, alpha=bundle.lora_alpha,
                       capacity=SERVE_BATCH["max_adapters"])
    for a in range(64):
        bank.add(f"silo_{a}", {k: 0.1 * torch.randn(v.shape, generator=gen)
                               for k, v in template.items()})
    slots = SERVE_BATCH["slots"]
    sched = DecodeScheduler(bundle.module, bundle.cfg, base, bank,
                            slots=slots, block_size=SERVE_BATCH["block_size"],
                            prefill_chunk=SERVE_BATCH["prefill_chunk"],
                            device=dev)
    for i in range(slots):
        ids = [BOS] + tok.encode(SERVE_PROMPTS[i]) + [SEP]
        sched.admit(ids, adapter_idx=1 + i, max_new_tokens=4 * n + 8)
    label = (f"FedLLM causal LM d{bundle.cfg.hidden_size} x"
             f"{bundle.cfg.num_layers} layers, bf16, {slots} slots, "
             f"64-adapter bank")
    # one 32-token chunk of a fresh prompt: the prefill program and its
    # write, on a row of its own (no slot is taken)
    chunk = SERVE_BATCH["prefill_chunk"]
    ids = [BOS] + tok.encode(("summarize round 7 " * 4)[:chunk - 1])
    toks = sched._dev(np.asarray(ids, np.int32))
    row = sched._dev(sched._tables[0])

    def prefill():
        with torch.no_grad():
            logits, kcs, vcs = sched._prefill_fn(
                sched.params, sched._stack(), sched._kp, sched._vp, row,
                toks, 0, len(ids), 1)
        # written to the trash block: valid rows routed there by n_valid 0
        sched._dispatch("llm_prefill_write", sched._chunk_write_fn,
                        sched._kp, sched._vp, row, 0, 0, kcs, vcs)
        return logits

    print(f"card: {torch.cuda.get_device_name(0)}")
    for what, fn in (("decode step", sched.step), ("prefill chunk", prefill)):
        fn()   # warm-up
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        step_ms = (time.time() - t0) / n * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        # the named range also shows up as a device-side annotation
        # spanning its kernels: leave it out of the kernel events, and take
        # its share from the host-side range's device time (the kernels it
        # launched)
        events = [e for e in device_events(prof, DeviceType)
                  if e.key != "cached_attention"]
        if not events:
            print("profile_torch_step: the profiler recorded no device time",
                  file=sys.stderr)
            return 1
        busy = sum(_dev_us(e) for e in events) / n / 1e3
        span_ms = sum(_dev_us(e) for e in device_events(prof, DeviceType)
                      if e.key == "cached_attention") / n / 1e3
        attn_ms = sum(getattr(e, "device_time_total",
                              getattr(e, "cuda_time_total", 0.0))
                      for e in prof.key_averages()
                      if e.key == "cached_attention"
                      and e.device_type == DeviceType.CPU) / n / 1e3
        print(f"{what}: {step_ms:.3f} ms unprofiled ({label}); device busy "
              f"{busy:.3f} ms = {busy / step_ms:.1%}, idle "
              f"{1 - busy / step_ms:.1%}; {len(events)} kernel names, "
              f"{sum(e.count for e in events) // n} launches per "
              f"{what}; cached_attention's kernels {attn_ms:.3f} ms "
              f"({attn_ms / busy:.1%} of device time; first to last of its "
              f"kernels on the device {span_ms:.3f} ms)")
        print("top kernels by device time (ms per call, share of device "
              "time):")
        total = busy * n * 1e3
        for e in sorted(events, key=_dev_us, reverse=True)[:12]:
            print(f"  {_dev_us(e) / n / 1e3:8.3f}  {_dev_us(e) / total:6.1%}"
                  f"  x{e.count // n:<4d} {e.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
