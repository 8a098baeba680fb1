#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fedml_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and the CUDA
toolkit. Phases, in order; any failure exits non-zero before the last line:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of the path from the sources in the checkout (nvcc,
   sm_90a), with the build time and the compiler's register/shared-memory
   report;
3. check each kernel against its plain PyTorch version on the card, at
   every ResNet-56 block geometry (batch 32) and the odd shapes of the
   parity tests, in float32 and bfloat16, gradients included;
4. time each ResNet-56 geometry with CUDA events: the kernel, its plain
   version, the unfused cuDNN chain (``library_ms``) and the bound;
5. a tiny run of the whole slice on the card against the same run on the
   CPU;
6. the main path: ``fedml_tpu_torch.run_simulation`` at ResNet-56's full
   width (FedAvg, synthetic CIFAR-10, bf16, fused conv block), with the
   kernel's launch count held to 27 per forward pass;
7. one JSON line describing each kernel, then the card line, then
   ``{"ok": true, "device": {...}}`` as the last line.

Imports nothing of JAX or ``fedml_tpu``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# float32 outside them, and HBM3 bandwidth. Rates assume a 700 W limit.
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# ResNet-56 BasicBlock geometries at batch 32: (h, cin, cout, stride) and
# how many of the 27 blocks have each
FLAGSHIP = [((32, 16, 16, 1), 9), ((32, 16, 32, 2), 1), ((16, 32, 32, 1), 8),
            ((16, 32, 64, 2), 1), ((8, 64, 64, 1), 8)]
BATCH = 32
# the odd shapes of tests/test_conv_block.py and the batch that is not a
# multiple of its grid block: (n, h, w, cin, cout, stride)
ODD = [(2, 7, 9, 16, 16, 1), (2, 7, 7, 16, 32, 2), (2, 9, 8, 16, 32, 2),
       (2, 8, 8, 16, 32, 1), (11, 8, 8, 16, 16, 1)]

# Forward tolerances, |kernel - plain| <= atol + rtol * |plain|:
#  float32: the kernel and cuDNN (TF32 off) sum 144-576-term dot products
#  and 16k-element GroupNorm sums in different orders (~1e-6 relative);
#  bfloat16: the kernel keeps f32 intermediates and rounds once on output,
#  so it is held to the plain version in f32 on the same bf16 inputs, within
#  one bf16 rounding (2^-8 relative) of the output.
FWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (8e-3, 2e-3)}
# Gradients: the kernel's backward recomputes the plain version, so the two
# differ only by the card's run-to-run summation order; error relative to
# the largest gradient entry.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

MAIN_PATH = dict(
    backend="gpu", dataset="synthetic_cifar10", model="resnet56",
    precision="bfloat16", fused_conv_block="pallas", client_num_in_total=64,
    client_num_per_round=8, comm_round=2, epochs=1, batch_size=32,
    learning_rate=0.1, synthetic_size=50000, synthetic_test_size=1000,
    frequency_of_the_test=1, random_seed=0)


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_block(torch, gen, n, h, w, cin, cout, stride, dtype, device):
    """Random input and block params (the parity tests' scales), drawn on
    the CPU from ``gen`` and moved to ``device``."""
    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(
            device, dtype)

    p = {"w1": rnd(3, 3, cin, cout, scale=0.2),
         "g1_scale": rnd(cout, scale=0.1, shift=1.0),
         "g1_bias": rnd(cout, scale=0.1),
         "w2": rnd(3, 3, cout, cout, scale=0.2),
         "g2_scale": rnd(cout, scale=0.1, shift=1.0),
         "g2_bias": rnd(cout, scale=0.1)}
    if stride != 1 or cin != cout:
        p.update(wp=rnd(1, 1, cin, cout, scale=0.2),
                 gp_scale=rnd(cout, scale=0.1, shift=1.0),
                 gp_bias=rnd(cout, scale=0.1))
    return rnd(n, h, w, cin), p


def check_case(torch, cb, gen, shape, dtype):
    """Forward and gradients of the kernel against the plain version.
    Returns (max abs forward error, max relative gradient error)."""
    n, h, w, cin, cout, s = shape
    dt = getattr(torch, dtype)
    x, p = make_block(torch, gen, n, h, w, cin, cout, s, dt, "cuda")
    out = cb.fused_block(x, p, strides=s, groups=8)
    torch.cuda.synchronize()
    require(out.dtype == dt and tuple(out.shape) == (
        n, -(-h // s), -(-w // s), cout), f"{shape} {dtype}: bad output")
    ref = cb.reference_block(x.float(), {k: v.float() for k, v in p.items()},
                             strides=s, groups=8)
    err = (out.float() - ref).abs()
    rtol, atol = FWD_TOL[dtype]
    bad = int((err > atol + rtol * ref.abs()).sum())
    require(torch.isfinite(out.float()).all().item(),
            f"{shape} {dtype}: non-finite output")
    require(bad == 0, f"{shape} {dtype}: {bad} outputs beyond tolerance "
                      f"(max abs err {err.max().item():.3e})")
    cot = torch.randn(out.shape, generator=gen).to("cuda")
    grads = []
    for fn in (cb.fused_block, cb.reference_block):
        leaves = [x.detach().clone().requires_grad_()] + [
            v.detach().clone().requires_grad_() for v in p.values()]
        o = fn(leaves[0], dict(zip(p, leaves[1:])), strides=s, groups=8)
        grads.append(torch.autograd.grad((o.float() * cot).sum(), leaves))
    gerr = max(((a.float() - b.float()).abs().max() /
                b.float().abs().max().clamp(min=1e-30)).item()
               for a, b in zip(*grads))
    require(gerr <= GRAD_TOL[dtype],
            f"{shape} {dtype}: gradient error {gerr:.3e}")
    return err.max().item(), gerr


def time_ms(torch, fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def library_block(torch, F, x_nchw, w, s, groups, eps):
    """The unfused cuDNN chain on channels-last NCHW tensors: conv2d,
    group_norm, relu, conv2d, group_norm, (conv2d, group_norm), add, relu.
    Padding is torch's symmetric padding=1 (the yardstick's timing does not
    depend on which side pads)."""
    y = F.conv2d(x_nchw, w["w1"], stride=s, padding=1)
    y = torch.relu(F.group_norm(y, groups, w["g1_scale"], w["g1_bias"], eps))
    y = F.conv2d(y, w["w2"], padding=1)
    y = F.group_norm(y, groups, w["g2_scale"], w["g2_bias"], eps)
    r = x_nchw
    if "wp" in w:
        r = F.conv2d(x_nchw, w["wp"], stride=s)
        r = F.group_norm(r, groups, w["gp_scale"], w["gp_bias"], eps)
    return torch.relu(r + y)


def block_cost(n, h, cin, cout, s, itemsize):
    """(bytes, ops) one block must move and do: x, every param and the
    output once each; the conv multiply-adds (2 ops each) plus ~7 ops per
    element for each GroupNorm and 1 each for the ReLUs and the add."""
    ho = -(-h // s)
    proj = s != 1 or cin != cout
    params = 9 * cin * cout + 9 * cout * cout + 4 * cout + (
        cin * cout + 2 * cout if proj else 0)
    nbytes = itemsize * (n * h * h * cin + n * ho * ho * cout + params)
    elems = n * ho * ho * cout
    macs = elems * (9 * cin + 9 * cout + (cin if proj else 0))
    ops = 2 * macs + elems * (7 * (3 if proj else 2) + 3)
    return nbytes, ops


def time_geometries(torch, F, cb, gen, dtype):
    """Per-geometry (kernel, plain, library, bound) ms at batch 32."""
    dt = getattr(torch, dtype)
    rows = []
    for (h, cin, cout, s), count in FLAGSHIP:
        x, p = make_block(torch, gen, BATCH, h, h, cin, cout, s, dt, "cuda")
        x_nchw = x.permute(0, 3, 1, 2)  # channels-last memory, no copy
        w = {k: (v.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last) if v.dim() == 4 else v)
            for k, v in p.items()}
        with torch.no_grad():
            k_ms = time_ms(torch, lambda: cb.fused_block(x, p, strides=s))
            p_ms = time_ms(torch, lambda: cb.reference_block(x, p,
                                                             strides=s))
            l_ms = time_ms(torch, lambda: library_block(
                torch, F, x_nchw, w, s, 8, cb.GN_EPS))
        nbytes, ops = block_cost(BATCH, h, cin, cout, s, x.element_size())
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = ops / PEAK_OPS[dtype] * 1e3
        rows.append(dict(geometry=f"{h}x{h}x{cin}->{cout} s{s}", count=count,
                         ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                         bytes_ms=t_bytes, ops_ms=t_ops,
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations"))
    return rows


def tiny_run_agreement(torch, fedml):
    """The whole slice on the card (kernel forward, f32) against the same
    run on the CPU (plain forward), from the same seeded init: one round,
    two clients, bound rtol 1e-3, atol 1e-4. Kept short and
    at a small learning rate on purpose: cuDNN's backward on the card is not
    bitwise reproducible, and at lr 0.05 over 2 rounds two runs of the plain
    version on the card already drift apart by about the bound."""
    cfg = dict(dataset="synthetic_cifar10", model="resnet20",
               client_num_in_total=4, client_num_per_round=2, comm_round=1,
               batch_size=8, learning_rate=0.01, max_total_samples=64,
               synthetic_test_size=64, frequency_of_the_test=1,
               random_seed=3, fused_conv_block="pallas")
    gpu = fedml.run_simulation(**cfg)
    cpu = fedml.run_simulation(device="cpu", **cfg)
    worst = 0.0
    for k, v in cpu["params"].items():
        g = gpu["params"][k].cpu()
        worst = max(worst, ((g - v).abs() / (1e-4 + 1e-3 * v.abs()))
                    .max().item())
    require(worst <= 1.0, f"tiny run: card vs CPU params off by {worst:.2f}"
                          f"x the tolerance")
    require(abs(gpu["final_test_acc"] - cpu["final_test_acc"]) <= 1 / 64,
            "tiny run: test accuracy differs by more than one sample")
    return worst, gpu["final_test_acc"], cpu["final_test_acc"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        import fedml_tpu_torch as fedml
        from fedml_tpu_torch.core.kernels import build
        from fedml_tpu_torch.core.kernels import conv_block as cb
    except ImportError as e:
        print(f"chip_smoke: the fedml_tpu_torch package is missing ({e}); "
              f"run from the root of a checkout", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    # cuDNN runs f32 convolutions in TF32 by default; the f32 reference
    # must be full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.time()
    lib = build.build("conv_block")
    print(f"build: conv_block.cu in {time.time() - t0:.1f} s -> {lib.name}",
          flush=True)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")

    gen = torch.Generator().manual_seed(0)
    main_err = 0.0
    for dtype in ("float32", "bfloat16"):
        shapes = [(BATCH, h, h, cin, cout, s)
                  for (h, cin, cout, s), _ in FLAGSHIP] + ODD
        for shape in shapes:
            err, gerr = check_case(torch, cb, gen, shape, dtype)
            if dtype == MAIN_PATH["precision"] and shape[0] == BATCH:
                main_err = max(main_err, err)
            print(f"check {dtype:8s} n,h,w,cin,cout,s={shape}: max abs err "
                  f"{err:.3e}, grad rel err {gerr:.3e}", flush=True)

    rows = time_geometries(torch, F, cb, gen, MAIN_PATH["precision"])
    for r in rows:
        print(f"time bf16 bs{BATCH} {r['geometry']} x{r['count']}: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, cuDNN "
              f"chain {r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} "
              f"ms ({r['bound_by']})", flush=True)
    per_fwd = {k: sum(r[k] * r["count"] for r in rows)
               for k in ("ms", "plain_ms", "library_ms", "bytes_ms",
                         "ops_ms")}
    # the 27 launches together: their bytes over the memory rate against
    # their operations over the peak
    per_fwd["bound_ms"] = max(per_fwd["bytes_ms"], per_fwd["ops_ms"])
    per_fwd["bound_by"] = ("bytes" if per_fwd["bytes_ms"] >= per_fwd["ops_ms"]
                           else "operations")
    print(f"time per ResNet-56 forward (27 blocks, bs{BATCH}, bf16): "
          f"kernel {per_fwd['ms']:.3f} ms, plain {per_fwd['plain_ms']:.3f} "
          f"ms, cuDNN chain {per_fwd['library_ms']:.3f} ms, bound "
          f"{per_fwd['bound_ms']:.4f} ms ({per_fwd['bound_by']})", flush=True)

    worst, acc_gpu, acc_cpu = tiny_run_agreement(torch, fedml)
    print(f"tiny run (resnet20, f32): card vs CPU params within "
          f"{worst:.3f} of tolerance; test acc {acc_gpu} vs {acc_cpu}",
          flush=True)

    cb.fused_block.launches = 0
    t0 = time.time()
    result = fedml.run_simulation(**MAIN_PATH)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = cb.fused_block.launches
    hist = result["history"]
    for h in hist:
        print(f"main path round {h['round']}: {h['round_time_s']:.2f} s, "
              f"{h['local_steps']} local steps, train_loss "
              f"{h['train_loss']:.4f}, test_acc {h['test_acc']:.4f}",
              flush=True)
        require(all(math.isfinite(h[k]) for k in (
            "train_loss", "train_acc", "test_acc", "test_loss")),
            f"round {h['round']}: non-finite metrics")
    require(all(torch.isfinite(v).all().item()
                for v in result["params"].values()), "non-finite params")
    forwards = sum(h["local_steps"] + h.get("eval_batches", 0) for h in hist)
    require(launches == 27 * forwards,
            f"kernel launched {launches} times, expected 27 x {forwards}")
    print(f"main path: {wall:.1f} s end to end, {wall / len(hist):.2f} s per "
          f"round (eval included), {launches} kernel launches = 27 x "
          f"{forwards} forward passes", flush=True)

    kernels = [{
        "name": "conv_block", "route": "cuda",
        "source": "fedml_tpu_torch/core/kernels/csrc/conv_block.cu",
        "replaces": "fedml_tpu/core/kernels/conv_block.py:144",
        "launches": launches, "max_abs_err": main_err,
        "ms": per_fwd["ms"], "plain_ms": per_fwd["plain_ms"],
        "bound_ms": per_fwd["bound_ms"], "bound_by": per_fwd["bound_by"],
        "library_ms": per_fwd["library_ms"]}]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
