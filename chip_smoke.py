#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fedml_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and the CUDA
toolkit. Phases, in order; any failure exits non-zero before the last line:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from the sources in the checkout (one nvcc per
   source, all started together; sm_90a), with the build time and the
   compiler's register/shared-memory/spill report; a spill in a
   tensor-core kernel, or a bf16 CUDA-core B1-B4 in the build, fails;
3. check each kernel against its plain PyTorch version on the card:
   B1 (fused conv block) at every ResNet-56 block geometry (batch 32) and
   the odd shapes of its parity tests; B2-B4 (flash attention forward, dQ,
   dK/dV) at the FedLLM round's shape, the 111M hot loop's, long context
   and the odd shapes of ``tests/test_llm.py`` (key-padding masks, rows
   with no live key, d 8/100/128 with ragged s); float32 and bfloat16,
   gradients included, and the autograd Function against dense attention;
4. time each kernel at the main paths' shapes (B2-B4 at the FedLLM
   round's and the hot loop's): the kernel with CUDA events around eager
   calls and as device time (calls captured in a CUDA graph, its replay
   timed with CUDA events), its plain version, the device time of one
   PyTorch library call for the same function (``library_ms``) and the
   bound; B1-B4 must run the kernel their dtype selects (the kernels in
   the captured graph);
5. tiny runs of both paths on the card against the same runs on the CPU
   (ResNet-20 FedAvg; the federated LoRA causal LM with flash attention);
6. the ResNet main path: ``fedml_tpu_torch.run_simulation`` at ResNet-56's
   full width (FedAvg, synthetic CIFAR-10, bf16, fused conv block), B1's
   launches held to 27 per forward pass;
7. the FedLLM main path: ``fedml_tpu_torch.llm.run_federated_llm`` at
   ``bench.py``'s ``bench_federated_lora`` configuration (d 512, 4 layers,
   seq 256, bf16, LoRA r8, 2 silos, Shakespeare), 2 rounds with eval after
   each, B2 launches held to 4 per forward and B3/B4 to 4 per local step;
8. the serving path: the FedLLM main path's model, base weights frozen
   and the adapter the run of phase 7 trained, served through
   ``fedml_tpu_torch.serving.llm_template.CausalLMPredictor`` with
   ``bench.py``'s ``bench_llm_serving`` traffic (24 new tokens, concurrency
   1 / 8 / 64): single mode as the sequential baseline (B2 per layer per
   token), then batch mode (64 slots, paged KV cache) with a bank of 1
   adapter and of 64; before it, the cache arithmetic against the CPU,
   decode against the full forward (f32 tiny, bf16 full width), greedy
   parity single vs batch on a full fine-tune, adapter isolation; a
   ``{"serving": ...}`` line;
9. the LLM hot loop: 4 SGD steps of the 111M causal LM (bs 8 x seq 1024,
   bf16, full parameters), 8 launches of each attention kernel per step;
10. one JSON line describing each kernel, then the card line, then
    ``{"ok": true, "device": {...}}`` as the last line.

Each main path is driven with every launch count set to 0 just before it
and read just after. Imports nothing of JAX or ``fedml_tpu``.
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
#  bfloat16: the tensor-core kernel rounds y1 to bf16 once, as conv2's A
#  operand (as the plain version in bf16 does: its GroupNorm casts back to
#  x's type), keeps everything else f32 and rounds the output once. So it
#  is held to the plain version in f32 on the same bf16 inputs with y1
#  rounded at the same place (plain_block_y1_bf16), within one bf16
#  rounding (2^-8 relative) of the output.
FWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (8e-3, 2e-3)}
# bfloat16 B1 is also held to the plain version without that rounding, in
# f32 and in bf16, by its largest error relative to the largest output
# entry. f32: y1's rounding (2^-9 relative) carried through conv2 and GN2,
# plus the output's own rounding, stays within one bf16 ulp of the largest
# entry (2^-7). bf16: the plain version also rounds conv2's output, both
# GroupNorms' and the residual sum, so the two can differ by two ulps of
# the largest entry (2^-6).
B1_PLAIN_TOL = {"float32": 2 ** -7, "bfloat16": 2 ** -6}
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

# The FedLLM main path: bench.py's bench_federated_lora ("BASELINE.json
# config 4 as a federated round") at its full width, 2 rounds, eval after
# each.
LLM_MAIN_PATH = dict(
    dataset="llm", model="causal_lm", precision="bfloat16",
    client_num_in_total=2, client_num_per_round=2, comm_round=2, epochs=1,
    batch_size=8, learning_rate=1e-3, federated_optimizer="fedavg",
    frequency_of_the_test=1, random_seed=0,
    llm_corpus_fallback="shakespeare", llm_hidden_size=512,
    llm_intermediate_size=1408, llm_num_layers=4, llm_num_heads=8,
    llm_max_seq_len=256, lora_rank=8, llm_attention_impl="flash")
# The FedLLM hot loop: bench.py's _llm_train_step_timing model (~111M
# params) at bench_llm_mfu's bs 8 x seq 1024, bf16, flash attention.
HOT_LOOP = dict(vocab_size=8192, hidden_size=1024, intermediate_size=2816,
                num_layers=8, num_heads=8, max_seq_len=1024,
                dtype="bfloat16", attention_impl="flash")
HOT_BATCH, HOT_STEPS = 8, 4
# The serving path: bench.py's bench_llm_serving traffic on the FedLLM main
# path's model (its prompts, 24 new tokens, concurrency 1/8/64, a bank of
# 1 and of 64 adapters; 64 slots, blocks of 16, prefill chunks of 32).
SERVE_MAX_NEW = 24
SERVE_CONC = (1, 8, 64)
SERVE_BATCH = {"slots": 64, "block_size": 16, "prefill_chunk": 32,
               "max_adapters": 66, "request_timeout_s": 600.0}
SERVE_PROMPTS = [f"request {i}: summarize federated round {i * 7}"
                 for i in range(max(SERVE_CONC))]
# tests/test_serving_batch.py's TestKVParity prompts
PARITY_PROMPTS = ["add 2 3", "echo hello world", "x",
                  "subtract 19 4 and then explain"]
# Decode step vs the full forward at the same position, error relative to
# the row's largest logit. f32 (dense, TF32 off): both sum the same terms
# in different orders and shapes. bf16 at full width: single mode merges
# the adapter into W before the bf16 cast and its flash forward (B2) rounds
# P to bf16, the decode step keeps the adapter factored in f32 and its
# attention in f32; the two differ by a few bf16 roundings through four
# layers.
DECODE_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# single vs batch greedy on a full fine-tune may part only where the single
# path's top two logits are closer than this
TIE_GAP = 1e-4

# Attention shapes (b, s, h, d, mask): the FedLLM round (no key mask, as
# the trainer calls the model), the hot loop, bench_long_context, and the
# odd shapes of tests/test_llm.py and tests/test_torch_attention.py:
# random key padding, and masked prefixes that leave rows with no live key
# (within one 64-row tile and across tiles).
ATTN_MAIN = (8, 256, 8, 64, "none")
ATTN_HOT = (8, 1024, 8, 128, "none")
ATTN_SHAPES = [ATTN_MAIN, ATTN_HOT, (1, 4096, 8, 128, "none"),
               (2, 16, 2, 8, "none"), (2, 32, 2, 8, "random"),
               (1, 16, 1, 8, "prefix4"), (2, 100, 2, 8, "random"),
               (2, 100, 2, 8, "prefix4"), (2, 200, 2, 64, "prefix70"),
               (2, 200, 2, 128, "prefix70"), (1, 130, 3, 100, "random")]
# Attention tolerances. Error relative to the largest entry of the plain
# result (sums over up to s terms of either sign): float32 within f32
# reordering; bfloat16 within one rounding of the largest entry. Gradients
# in both dtypes, and O in bfloat16: the tensor-core forward rounds P to
# bf16 before P.V (as FlashAttention-2/3 do), so an entry of O carries the
# rounding of its weights (2^-9 relative each) besides its own, and a small
# entry can be off by more than its own ulp.
ATTN_GRAD_TOL = {"float32": 1e-4, "bfloat16": 8e-3}
# O in float32, elementwise |kernel - plain| <= atol + rtol*|plain|: both
# sum in f32 in different orders (~1e-6 relative). LSE is f32 in both
# dtypes and held the same way.
ATTN_FWD_TOL = (1e-4, 1e-5)
ATTN_LSE_TOL = (1e-5, 1e-5)
# The CUDA kernel each wrapper launches, by dtype.
KERNEL_NAME = {
    "bfloat16": {"fwd": "flash_fwd_mma_kernel", "dq": "flash_dq_mma_kernel",
                 "dkv": "flash_dkv_mma_kernel"},
    "float32": {"fwd": "flash_fwd_kernel", "dq": "flash_dq_kernel",
                "dkv": "flash_dkv_kernel"}}
B1_KERNEL_NAME = {"bfloat16": "conv_block_mma_kernel",
                  "float32": "conv_block_kernel"}
# What each kernel of the {"kernels": [...]} line is built from.
DESIGN = {
    "conv_block": "bf16: mma.sync m16n8k16 implicit GEMM + ldmatrix, a "
                  "thread-block cluster per sample (a band of rows per "
                  "CTA), GroupNorm and conv2's halo across the cluster "
                  "through distributed shared memory; f32: SIMT, one CTA "
                  "per sample",
    "flash_fwd": "bf16: mma.sync m16n8k16 + ldmatrix + cp.async 2-stage "
                 "ring; f32: SIMT",
    "flash_dq": "bf16: mma.sync m16n8k16 + ldmatrix + cp.async 2-stage "
                "ring, keys 32 at a time; f32: SIMT",
    "flash_dkv": "bf16: mma.sync m16n8k16 + ldmatrix + cp.async 2-stage "
                 "ring; f32: SIMT"}


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


def plain_block_y1_bf16(torch, cb, x, p, s, groups=8):
    """``reference_block`` in f32 with y1 rounded to bf16 before conv2: the
    plain version of the bf16 kernel's numerics."""
    y = cb._conv_same(x, p["w1"], s)
    y = torch.relu(cb._group_norm(y, p["g1_scale"], p["g1_bias"], groups,
                                  cb.GN_EPS))
    y = cb._conv_same(y.bfloat16().float(), p["w2"], 1)
    y = cb._group_norm(y, p["g2_scale"], p["g2_bias"], groups, cb.GN_EPS)
    r = x
    if "wp" in p:
        r = cb._group_norm(cb._conv_same(x, p["wp"], s), p["gp_scale"],
                           p["gp_bias"], groups, cb.GN_EPS)
    return torch.relu(r + y)


def check_case(torch, cb, gen, shape, dtype):
    """Forward and gradients of the kernel against the plain version.
    Returns (max abs forward error against the plain version in f32, max
    relative gradient error, and for bf16 the max abs error against the
    plain version in bf16, else None)."""
    n, h, w, cin, cout, s = shape
    dt = getattr(torch, dtype)
    if dtype == "bfloat16":
        # the wrapper's footprint is the kernel's (csrc band_layout)
        k = cb.cluster_for(n, h, w, cout, s)
        need = cb._lib().conv_block_mma_smem_bytes(h, w, cin, cout, s, k)
        require(need == cb.smem_bytes(h, w, cin, cout, s, 8, dt, k),
                f"{shape}: the kernel needs {need} bytes of shared memory, "
                f"the wrapper reckons "
                f"{cb.smem_bytes(h, w, cin, cout, s, 8, dt, k)}")
    x, p = make_block(torch, gen, n, h, w, cin, cout, s, dt, "cuda")
    out = cb.fused_block(x, p, strides=s, groups=8)
    torch.cuda.synchronize()
    require(out.dtype == dt and tuple(out.shape) == (
        n, -(-h // s), -(-w // s), cout), f"{shape} {dtype}: bad output")
    # fixed reduction orders (in bf16 across the cluster too): a second
    # launch gives the same bits
    require(torch.equal(out, cb.fused_block(x, p, strides=s, groups=8)),
            f"{shape} {dtype}: two launches differ")
    xf, pf = x.float(), {k: v.float() for k, v in p.items()}
    ref = cb.reference_block(xf, pf, strides=s, groups=8)
    err = (out.float() - ref).abs()
    require(torch.isfinite(out.float()).all().item(),
            f"{shape} {dtype}: non-finite output")
    rtol, atol = FWD_TOL[dtype]
    err16 = None
    if dtype == "bfloat16":
        ref_y1 = plain_block_y1_bf16(torch, cb, xf, pf, s)
        e = (out.float() - ref_y1).abs()
        bad = int((e > atol + rtol * ref_y1.abs()).sum())
        require(bad == 0, f"{shape} {dtype}: {bad} outputs beyond tolerance "
                          f"of the plain version with y1 in bf16 (max abs "
                          f"err {e.max().item():.3e})")
        ref16 = cb.reference_block(x, p, strides=s, groups=8).float()
        err16 = (out.float() - ref16).abs().max().item()
        for name, r, e in (("float32", ref, err.max().item()),
                           ("bfloat16", ref16, err16)):
            rel = e / r.abs().max().item()
            require(rel <= B1_PLAIN_TOL[name],
                    f"{shape} {dtype}: off the plain version in {name} by "
                    f"{rel:.3e} of its largest entry")
    else:
        bad = int((err > atol + rtol * ref.abs()).sum())
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
    return err.max().item(), gerr, err16


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
    """Per-geometry ms at batch 32: the kernel (CUDA events, and device
    time), its plain version, the unfused cuDNN chain (device time as
    ``library_ms``, and CUDA events) and the bound."""
    dt = getattr(torch, dtype)
    rows = []
    for (h, cin, cout, s), count in FLAGSHIP:
        x, p = make_block(torch, gen, BATCH, h, h, cin, cout, s, dt, "cuda")
        x_nchw = x.permute(0, 3, 1, 2)  # channels-last memory, no copy
        w = {k: (v.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last) if v.dim() == 4 else v)
            for k, v in p.items()}

        def kernel():
            return cb.fused_block(x, p, strides=s)

        def chain():
            return library_block(torch, F, x_nchw, w, s, 8, cb.GN_EPS)

        with torch.no_grad():
            k_ms = time_ms(torch, kernel)
            k_dev, names = device_ms(torch, kernel)
            p_ms = time_ms(torch, lambda: cb.reference_block(x, p,
                                                             strides=s))
            l_ms = time_ms(torch, chain)
            l_dev, _ = device_ms(torch, chain)
        # one kernel per dtype: bf16 B1 is the tensor-core cluster kernel
        want = B1_KERNEL_NAME[dtype]
        require(any(want in n for n in names) and not any(
            "conv_block" in n and want not in n for n in names),
            f"conv_block in {dtype} ran {names}, not {want}")
        nbytes, ops = block_cost(BATCH, h, cin, cout, s, x.element_size())
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = ops / PEAK_OPS[dtype] * 1e3
        rows.append(dict(geometry=f"{h}x{h}x{cin}->{cout} s{s}", count=count,
                         cluster=cb.cluster_for(BATCH, h, h, cout, s),
                         ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                         library_ms=l_dev, library_event_ms=l_ms,
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


def build_all(build, names):
    """One nvcc per source, all started together; print each build's
    time and the compiler's register, shared-memory and spill lines.
    Returns {kernel (mangled name): bytes spilled (stores + loads)}."""
    from concurrent.futures import ThreadPoolExecutor

    def one(name):
        t0 = time.time()
        return name, build.build(name), time.time() - t0

    with ThreadPoolExecutor(len(names)) as pool:
        done = list(pool.map(one, names))
    spilled, fn = {}, None
    for name, lib, dt in done:
        print(f"build: {name}.cu in {dt:.1f} s -> {lib.name}", flush=True)
        for line in lib.with_suffix(".log").read_text().splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "smem")):
                print(f"  ptxas: {line.strip()}")
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            elif "spill stores" in line and fn is not None:
                # "0 bytes stack frame, 0 bytes spill stores, 0 bytes
                # spill loads"
                words = line.replace(",", " ").split()
                spilled[fn] = sum(int(words[i - 2]) for i, w in
                                  enumerate(words) if w == "spill")
    return spilled


def attn_inputs(torch, gen, shape, dtype):
    """q, k, v, dO on the card in ``dtype`` and the f32 key mask (or
    None), drawn on the CPU from ``gen``."""
    b, s, h, d, mask = shape
    dt = getattr(torch, dtype)
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen).to("cuda", dt)
                  for _ in range(4))
    if mask == "none":
        m = None
    elif mask == "random":
        m = (torch.rand(b, s, generator=gen) > 0.3).float()
        m[:, 0] = 1.0
    else:  # "prefix<n>": the first n keys masked
        m = torch.ones(b, s)
        m[:, :int(mask[len("prefix"):])] = 0.0
    return q, k, v, g, None if m is None else m.to("cuda")


def rel_err(torch, got, ref):
    return ((got.float() - ref).abs().max() /
            ref.abs().max().clamp(min=1e-30)).item()


def check_attention(torch, fa, attn, gen, shape, dtype):
    """B2-B4 against their plain versions in f32 on the same inputs, the
    exact zeros of rows with no live key and of masked keys, and the
    autograd Function against dense attention. Returns (max abs error of
    O, of dQ, of dK/dV)."""
    b, s, h, d, mask = shape
    q, k, v, g, m = attn_inputs(torch, gen, shape, dtype)
    o, lse = fa.flash_fwd(q, k, v, m)
    torch.cuda.synchronize()
    require(o.dtype == q.dtype and tuple(o.shape) == (b, s, h, d)
            and tuple(lse.shape) == (b, h, s), f"{shape}: bad output")
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    ro, rlse = fa.reference_fwd(qf, kf, vf, m)
    err = (o.float() - ro).abs()
    require(torch.isfinite(o.float()).all().item(), f"{shape}: non-finite O")
    if dtype == "float32":
        rtol, atol = ATTN_FWD_TOL
        bad = int((err > atol + rtol * ro.abs()).sum())
        require(bad == 0, f"{shape} {dtype}: {bad} outputs of O beyond "
                          f"tolerance (max abs err {err.max().item():.3e})")
    else:
        oerr = rel_err(torch, o, ro)
        require(oerr <= ATTN_GRAD_TOL[dtype],
                f"{shape} {dtype}: O off by {oerr:.3e} of its largest entry")
    require(torch.isfinite(lse).all().item(), f"{shape}: non-finite LSE")
    lerr = (lse - rlse).abs()
    bad = int((lerr > ATTN_LSE_TOL[1] + ATTN_LSE_TOL[0] * rlse.abs()).sum())
    require(bad == 0, f"{shape} {dtype}: LSE off by {lerr.max().item():.3e}")
    dd = (g.float() * o.float()).sum(-1)
    dq = fa.flash_dq(q, k, v, m, g, lse, dd)
    dk, dv = fa.flash_dkv(q, k, v, m, g, lse, dd)
    torch.cuda.synchronize()
    require(all(torch.isfinite(t.float()).all().item() for t in (dq, dk, dv)),
            f"{shape} {dtype}: non-finite gradients")
    rdq = fa.reference_dq(qf, kf, vf, m, gf, lse, dd)
    rdk, rdv = fa.reference_dkv(qf, kf, vf, m, gf, lse, dd)
    gerr = max(rel_err(torch, a, r) for a, r in ((dq, rdq), (dk, rdk),
                                                 (dv, rdv)))
    require(gerr <= ATTN_GRAD_TOL[dtype],
            f"{shape} {dtype}: gradient error {gerr:.3e}")
    if m is not None:
        dead = (m == 0)[:, :, None, None].expand_as(dk)
        require(bool((dk[dead] == 0).all()) and bool((dv[dead] == 0).all()),
                f"{shape} {dtype}: masked keys got nonzero dK/dV")
    if mask.startswith("prefix"):
        n = int(mask[len("prefix"):])
        require(bool((o[:, :n] == 0).all()) and bool((dq[:, :n] == 0).all()),
                f"{shape} {dtype}: rows with no live key are not exactly 0")
        require(bool((lse[:, :, :n] < -1e29).all()),
                f"{shape} {dtype}: LSE of rows with no live key not -1e30")
    if not mask.startswith("prefix") and (
            dtype == "float32" and s <= 1024 or shape in (ATTN_MAIN,
                                                           ATTN_HOT)):
        # the autograd Function (D from the stored O, then B3 and B4) in
        # `dtype` against dense attention under autograd in f32 on the same
        # values: output and gradients
        outs, grads = [], []
        for fn, dt in ((attn.flash_causal_attention, q.dtype),
                       (attn.dense_causal_attention, torch.float32)):
            leaves = [t.detach().to(dt).requires_grad_() for t in (q, k, v)]
            out = fn(*leaves, attn_mask=m)
            outs.append(out.detach())
            grads.append(torch.autograd.grad((out.float() * gf).sum(),
                                             leaves))
        aerr = max(rel_err(torch, a, r) for a, r in zip(
            [outs[0], *grads[0]], [outs[1], *grads[1]]))
        require(aerr <= ATTN_GRAD_TOL[dtype],
                f"{shape} {dtype}: flash vs dense autograd output and "
                f"gradients off by {aerr:.3e}")
    return (err.max().item(), (dq.float() - rdq).abs().max().item(),
            max((dk.float() - rdk).abs().max().item(),
                (dv.float() - rdv).abs().max().item()))


def attention_cost(shape, itemsize, kernel):
    """(bytes, causal FLOPs) the kernel's function must move and do: each
    input read once and each output written once; 2·b·h·(s²/2)·d per
    product, 2 products for B2, 3 for B3 and 4 for B4."""
    b, s, h, d, _ = shape
    t = b * s * h * d * itemsize
    row = b * h * s * 4
    tensors, rows, products = {"fwd": (4, 1, 2), "dq": (5, 2, 3),
                               "dkv": (6, 2, 4)}[kernel]
    return tensors * t + rows * row, products * b * h * s * s * d


def device_ms(torch, fn, stream=None, iters=20, warmup=3):
    """(device time of one call of ``fn``, names of the kernels it runs):
    ``iters`` calls captured once into a CUDA graph on ``stream`` (a new
    side stream by default), the graph replayed once to warm it and then
    once more between two CUDA events. Replaying a graph launches its
    kernels back to back with no host in between, so unlike a clock around
    eager calls it leaves out the host's launch overhead. The names come
    from the graph's DOT dump (one node per kernel launch)."""
    import re

    stream = stream or torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    # keep_graph: the captured graph outlives capture_end, for debug_dump
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.instantiate()
    dot = os.path.join("build", "device_ms_graph.dot")
    os.makedirs("build", exist_ok=True)
    graph.debug_dump(dot)
    require(os.path.exists(dot), "the CUDA graph wrote no DOT dump")
    with open(dot) as f:
        text = f.read()
    os.unlink(dot)
    names = {t for t in re.split(r'[\s"|{}]+', text) if "kernel" in t}
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    graph.reset()
    ms = start.elapsed_time(end) / iters
    require(ms > 0 and names, f"the CUDA graph recorded no kernel "
                              f"({ms} ms; its DOT dump: {text[:800]!r})")
    return ms, names


def time_attention(torch, F, fa, gen, shape, dtype):
    """Per kernel, at ``shape`` in ``dtype``: ms of the kernel (CUDA events
    around back-to-back calls of its wrapper, so the wrapper's host time
    where it exceeds the kernel's) and its device time, its plain version,
    the library call's device time and the bound."""
    q, k, v, g, m = attn_inputs(torch, gen, shape, dtype)
    with torch.no_grad():
        o, lse = fa.flash_fwd(q, k, v, m)
        dd = (g.float() * o.float()).sum(-1)
    args = (q, k, v, m, g, lse, dd)
    # the yardstick: PyTorch's fused attention on [b, h, s, d] copies,
    # forward, and its autograd backward (dQ, dK, dV together), both as
    # device time. The forward whose backward is timed runs on the stream
    # the backward is captured on: autograd runs a backward op on its
    # forward's stream.
    ql, kl, vl = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    gl = g.transpose(1, 2).contiguous()
    with torch.no_grad():
        lib_fwd, _ = device_ms(torch, lambda: F.scaled_dot_product_attention(
            ql, kl, vl, is_causal=True))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_bwd, _ = device_ms(torch, lambda: torch.autograd.grad(
        ol, (ql, kl, vl), gl, retain_graph=True), stream=side)
    rows = {}
    with torch.no_grad():
        for kernel, fn, plain, lib in (
                ("fwd", lambda: fa.flash_fwd(q, k, v, m),
                 lambda: fa.reference_fwd(q, k, v, m), lib_fwd),
                ("dq", lambda: fa.flash_dq(*args),
                 lambda: fa.reference_dq(*args), lib_bwd),
                ("dkv", lambda: fa.flash_dkv(*args),
                 lambda: fa.reference_dkv(*args), lib_bwd)):
            nbytes, ops = attention_cost(shape, q.element_size(), kernel)
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_ops = ops / PEAK_OPS[dtype] * 1e3
            dev, names = device_ms(torch, fn)
            # one kernel per (kernel, dtype): bf16 B2-B4 are the
            # tensor-core kernels
            want = KERNEL_NAME[dtype][kernel]
            require(any(want in n for n in names) and not any(
                "flash" in n and want not in n for n in names),
                f"{kernel} in {dtype} ran {names}, not {want}")
            rows[kernel] = dict(
                ms=time_ms(torch, fn, iters=20), device_ms=dev,
                plain_ms=time_ms(torch, plain, iters=3, warmup=1),
                library_ms=lib, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
    return rows


def reset_launches(cb, fa):
    for fn in (cb.fused_block, fa.flash_fwd, fa.flash_dq, fa.flash_dkv):
        fn.launches = 0


def launches(cb, fa):
    return {"conv_block": cb.fused_block.launches,
            "flash_fwd": fa.flash_fwd.launches,
            "flash_dq": fa.flash_dq.launches,
            "flash_dkv": fa.flash_dkv.launches}


def tiny_llm_agreement(torch, run_federated_llm, Arguments):
    """The federated LoRA fine-tune on the card (B2-B4, f32) against the
    same run on the CPU (plain versions), from the same seeded base and
    adapters: 2 silos, 1 round, d 32, 1 layer, SGD at lr 0.05. The run is
    one round of plain SGD, so card-vs-CPU differences stay at float32
    reordering; bound rtol 1e-3, atol 1e-5 on every adapter entry."""
    cfg = dict(dataset="llm_synth", model="causal_lm",
               client_num_in_total=2, client_num_per_round=2, comm_round=1,
               epochs=1, batch_size=8, learning_rate=0.05,
               llm_corpus_size=48, llm_max_seq_len=40, llm_hidden_size=32,
               llm_num_layers=1, llm_num_heads=2, llm_intermediate_size=64,
               lora_rank=4, random_seed=5, frequency_of_the_test=1,
               llm_attention_impl="flash")
    gpu = run_federated_llm(Arguments(**cfg))
    cpu = run_federated_llm(Arguments(**cfg), device="cpu")
    worst, moved = 0.0, 0.0
    for key, c in cpu["params"].items():
        g = gpu["params"][key].cpu()
        worst = max(worst, ((g - c).abs() / (1e-5 + 1e-3 * c.abs()))
                    .max().item())
        if key.endswith("lora_b"):
            moved = max(moved, c.abs().max().item())
    require(moved > 0, "tiny LLM run: the adapters did not move")
    require(worst <= 1.0, f"tiny LLM run: card vs CPU adapters off by "
                          f"{worst:.2f}x the tolerance")
    hg, hc = gpu["history"][0], cpu["history"][0]
    require(abs(hg["test_loss"] - hc["test_loss"]) <= 1e-4 * abs(
        hc["test_loss"]), "tiny LLM run: test loss differs")
    return worst, hg["test_loss"], hc["test_loss"]


def hot_loop(torch, llm, cb, fa):
    """HOT_STEPS SGD steps (lr 1e-3) of the 111M causal LM on one batch of
    seeded random tokens, full parameters, as bench.py's
    _llm_train_step_timing does. Returns (ms per step over all but the
    first step, losses, launches, parameter count)."""
    from torch.func import functional_call

    cfg = llm.LLMConfig(**HOT_LOOP)
    model, params = llm.init_llm(cfg, torch.Generator().manual_seed(0))
    model.to("cuda")
    params = {k: v.to("cuda") for k, v in params.items()}
    spec = llm.CausalLMTrainer(
        lambda p, x, train=False: functional_call(model, p, (x,)))
    gen = torch.Generator().manual_seed(1)
    seq = cfg.max_seq_len
    batch = {"x": torch.randint(0, cfg.vocab_size, (HOT_BATCH, seq),
                                generator=gen).cuda(),
             "y": torch.randint(0, cfg.vocab_size, (HOT_BATCH, seq),
                                generator=gen).cuda(),
             "mask": torch.ones(HOT_BATCH).cuda()}
    losses = []
    reset_launches(cb, fa)
    t0 = None
    for step in range(HOT_STEPS):
        if step == 1:
            torch.cuda.synchronize()
            t0 = time.time()
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, _ = spec.loss(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            params = {k: v - 1e-3 * gr for (k, v), gr in
                      zip(params.items(), grads)}
        losses.append(loss.item())
    torch.cuda.synchronize()
    ms = (time.time() - t0) / (HOT_STEPS - 1) * 1e3
    return ms, losses, launches(cb, fa), llm.count_params(params)



def cache_arithmetic(torch, kvc):
    """The paged cache's gather, the three scatters and the copy-on-write
    at the serving geometry (64 slots, blocks of 16, seq 256, 8 heads of
    64, bf16 pools) on the card against the same calls on the CPU, on
    seeded inputs: integer indexing and copies, so bitwise (the trash
    block, where several dropped rows land on one row, left out)."""
    cfg = kvc.KVCacheConfig(num_layers=4, kv_heads=8, head_dim=64,
                            max_seq_len=256, block_size=16,
                            num_blocks=64 * 16)
    gen = torch.Generator().manual_seed(11)
    shape = (cfg.num_layers, cfg.num_blocks + 1, cfg.block_size, 8, 64)
    pool = torch.randn(shape, generator=gen).bfloat16()
    s, mb, bs, trash = 64, cfg.max_blocks_per_slot, 16, cfg.trash_block
    tables = torch.randperm(cfg.num_blocks, generator=gen)[:s * mb].reshape(
        s, mb).int()
    tables[5:9, 6:] = trash                   # short rows: trash tails
    pos = torch.randint(0, 256, (s,), generator=gen).int()
    active = torch.rand(s, generator=gen) > 0.2
    tok = torch.randn(s, 8, 64, generator=gen)
    chunk = torch.randn(8, 32, 8, 64, generator=gen)
    p0 = torch.randint(0, 224, (8,), generator=gen).int()
    cpos = p0[:, None] + torch.arange(32).int()[None, :]
    valid = torch.arange(32)[None, :] < torch.randint(
        0, 33, (8, 1), generator=gen)

    def run(dev):
        kp, tb = pool.to(dev).clone(), tables.to(dev)
        out = [kvc.gather_view(kp[2], tb)]
        kvc.scatter_token(kp, 1, tb, pos.to(dev), tok.to(dev),
                          active.to(dev), bs, trash)
        kvc.scatter_chunk(kp, 3, tb[7], cpos[0].to(dev), chunk[0].to(dev),
                          valid[0].to(dev), bs, trash)
        kvc.scatter_chunk_batch(kp, 0, tb[:8], cpos.to(dev), chunk.to(dev),
                                valid.to(dev), bs, trash)
        kvc.copy_block_rows(kp, int(tables[0, 0]), int(tables[1, 1]), 7)
        out.append(kp[:, :cfg.num_blocks])
        return [t.cpu() for t in out]

    for a, b in zip(run("cuda"), run("cpu")):
        require(torch.equal(a, b), "cache arithmetic: card and CPU differ")
    return s


def decode_vs_forward(torch, build_llm_bundle, Arguments, DecodeScheduler,
                      AdapterBank, args, adapter, dtype, dev="cuda"):
    """One decode step's logits for one slot against the full forward over
    the padded ``[1, max_seq_len]`` buffer at the same position (single
    mode's step), on the card; error relative to the row's largest
    logit."""
    from fedml_tpu_torch.llm.data import BOS, SEP
    bundle, tok = build_llm_bundle(Arguments(**args))
    bundle.to(dev)
    bank, params = None, bundle.base_params
    if adapter is None:     # full fine-tune: the params ARE the model
        params = {k: v.detach() for k, v in bundle.module.state_dict().items()}
    else:
        bank = AdapterBank(adapter, alpha=bundle.lora_alpha, capacity=2)
        bank.add("a", adapter)
    sched = DecodeScheduler(bundle.module, bundle.cfg, params, bank,
                            slots=4, block_size=16, prefill_chunk=32,
                            device=dev)
    ids = [BOS] + tok.encode("echo hello world, and then some") + [SEP]
    slot, first = sched.admit(ids, adapter_idx=0 if bank is None else 1,
                              max_new_tokens=8)
    with torch.no_grad():
        _, _, _, _, row = sched._step_fn(
            sched.params, sched._stack(), sched._kp, sched._vp,
            sched._dev(sched._tables), sched._dev(sched._pos),
            sched._dev(sched._active), sched._dev(sched._aidx).long(),
            sched._dev(sched._last), *sched._sampling(
                sched._temp, sched._seed, sched._pos + 1))
        buf = torch.zeros(1, bundle.cfg.max_seq_len, dtype=torch.int32,
                          device=dev)
        buf[0, :len(ids) + 1] = torch.tensor(ids + [first])
        ref = bundle.apply(params if adapter is None else adapter,
                           buf)[0, len(ids)]
    err = ((row[slot] - ref).abs().max() / ref.abs().max()).item()
    require(math.isfinite(err) and err <= DECODE_TOL[dtype],
            f"decode step vs full forward ({dtype}): {err:.3e} of the "
            f"largest logit > {DECODE_TOL[dtype]}")
    return err


def greedy_parity(torch, build_llm_bundle, Arguments, CausalLMPredictor,
                  dev="cuda"):
    """Batch-mode greedy tokens against single-mode tokens on a full
    fine-tune artifact (f32, dense, the FedLLM main path's width) for
    tests/test_serving_batch.py's four prompts, 12 new tokens each. cuBLAS
    may round the two shapes differently, so the two may part only where
    the single path's top-2 logit gap is below TIE_GAP; returns each
    parting (prompt, step, gap). Any other divergence fails."""
    from fedml_tpu_torch.llm.data import EOS
    args = dict(LLM_MAIN_PATH, precision="float32", lora_rank=0,
                llm_attention_impl="dense")
    bundle, tok = build_llm_bundle(Arguments(**args))
    params = {k: v.detach() for k, v in bundle.module.state_dict().items()}
    single = CausalLMPredictor(bundle, params, tokenizer=tok, device=dev)
    batch = CausalLMPredictor(bundle, params, tokenizer=tok, mode="batch",
                              batch_opts=dict(SERVE_BATCH, slots=4),
                              device=dev)
    parted = []

    def buf_of(ids):
        buf = torch.zeros(1, bundle.cfg.max_seq_len, dtype=torch.int32,
                          device=dev)
        buf[0, :len(ids)] = torch.tensor(ids)
        return buf

    try:
        for prompt in PARITY_PROMPTS:
            ids = single._encode_prompt(prompt, 12)
            a = []
            while len(a) < 12:   # single mode's own greedy step
                nxt = single._step(buf_of(ids + a), len(ids + a), 0.0, None)
                if nxt == EOS:
                    break
                a.append(nxt)
            b = batch.engine.submit(ids, max_new_tokens=12).result(
                timeout=SERVE_BATCH["request_timeout_s"])["ids"]
            if a == b:
                continue
            j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            with torch.no_grad():
                top = bundle.apply(params, buf_of(ids + a[:j]))[
                    0, len(ids) + j - 1].topk(2).values
            gap = (top[0] - top[1]).item()
            print(f"greedy parity: {prompt!r} parts at generated token {j} "
                  f"(single top-2 gap {gap:.3e})", flush=True)
            require(gap < TIE_GAP, f"greedy parity: {prompt!r} single {a} "
                                   f"vs batch {b}, top-2 gap {gap:.3e}")
            parted.append({"prompt": prompt, "step": j, "gap": gap})
    finally:
        batch.close()
    return parted


def isolation(torch, bundle, tok, bank, DecodeScheduler, dev="cuda"):
    """Two requests for two different adapters of the 64-adapter bank, run
    side by side in one decode step, each equal their solo runs (and the
    two differ)."""
    from fedml_tpu_torch.llm.data import BOS, SEP
    tok_ids = [BOS] + tok.encode("echo hello world") + [SEP]
    base = bundle.base_params
    names = ("silo_3", "silo_40")

    def run(which):
        sched = DecodeScheduler(bundle.module, bundle.cfg, base, bank,
                                slots=4, block_size=16, prefill_chunk=32,
                                device=dev)
        out = {}
        for n in which:
            slot, first = sched.admit(tok_ids, adapter_idx=bank.index(n),
                                      max_new_tokens=12)
            out[n] = (slot, [first])
        for _ in range(11):
            toks = sched.step()
            for n, (slot, seq) in out.items():
                seq.append(toks[slot])
        return {n: seq for n, (_, seq) in out.items()}

    pair = run(names)
    for n in names:
        require(run((n,))[n] == pair[n],
                f"isolation: {n} alongside another adapter != its solo run")
    require(pair[names[0]] != pair[names[1]],
            "isolation: two different adapters gave the same tokens")
    return True


def serve_sweep(pred, prompts, conc, adapter_names):
    """``conc`` requests at concurrency ``conc`` (bench_llm_serving's
    sweep): generated tokens/s over the sweep's wall and the p99 request
    latency from the sweep's start; returns it with the outputs."""
    import concurrent.futures as cf
    t0 = time.perf_counter()
    lats, outs = [0.0] * conc, [None] * conc

    def one(i):
        outs[i] = pred.generate(prompts[i], max_new_tokens=SERVE_MAX_NEW,
                                adapter=adapter_names[i % len(adapter_names)])
        lats[i] = time.perf_counter() - t0

    with cf.ThreadPoolExecutor(conc) as ex:
        for f in [ex.submit(one, i) for i in range(conc)]:
            f.result(timeout=SERVE_BATCH["request_timeout_s"])
    wall = time.perf_counter() - t0
    toks = sum(o["completion_tokens"] for o in outs)
    p99 = sorted(lats)[min(conc - 1, int(0.99 * (conc - 1) + 0.5))]
    return {"tokens_per_s": toks / wall, "p99_latency_s": p99,
            "tokens": toks, "wall_s": wall}, outs


def serving_phase(torch, llm, cb, fa, Arguments, adapter, dev="cuda"):
    """The serving path at the FedLLM main path's width: the base the run
    froze and the adapter it trained. Single mode (the sequential baseline,
    one request at a time as bench_llm_serving's lock does) then batch
    mode with banks of 1 and 64 adapters. Returns the serving line and the
    kernels' launches over the legs."""
    import threading
    from fedml_tpu_torch.serving.batch import AdapterBank, DecodeScheduler
    from fedml_tpu_torch.serving.llm_template import CausalLMPredictor

    bundle, tok = llm.build_llm_bundle(Arguments(**LLM_MAIN_PATH))
    legs, steps, ttft = {}, {}, {}
    lock = threading.Lock()
    single = CausalLMPredictor(bundle, adapter, tokenizer=tok, device=dev)
    single.generate("warm", max_new_tokens=2)

    def serial(prompt, max_new_tokens, adapter=None):
        with lock:   # the single path serves one request at a time
            return single.generate(prompt, max_new_tokens=max_new_tokens)

    class Serial:
        generate = staticmethod(serial)

    reset_launches(cb, fa)
    forwards = 0
    for c in SERVE_CONC:
        legs[f"sequential_c{c}"], outs = serve_sweep(Serial, SERVE_PROMPTS,
                                                     c, [None])
        forwards += sum(o["completion_tokens"] + (o["finish_reason"] ==
                                                  "stop") for o in outs)
    single_launches = launches(cb, fa)
    layers = LLM_MAIN_PATH["llm_num_layers"]
    require(single_launches == {"conv_block": 0, "flash_fwd": layers *
                                forwards, "flash_dq": 0, "flash_dkv": 0},
            f"single mode launches {single_launches}, expected "
            f"{layers} x {forwards} of B2 only")

    gen = torch.Generator().manual_seed(1)
    bank64 = None
    batch_launches = {}
    for tag, n_bank in (("bank1", 1), ("bank64", 64)):
        pred = CausalLMPredictor(bundle, adapter, tokenizer=tok,
                                 mode="batch", batch_opts=SERVE_BATCH,
                                 device=dev)
        names = [None]
        if n_bank > 1:
            for a in range(n_bank):
                pred.adapter_bank.add(f"silo_{a}", {
                    k: 0.1 * torch.randn(v.shape, generator=gen)
                    for k, v in adapter.items()})
            names = [f"silo_{a}" for a in range(n_bank)]
            bank64 = pred.adapter_bank
        try:
            pred.generate("warm", max_new_tokens=2, adapter=names[0])
            engine = pred.engine
            steps0 = engine.scheduler.steps_run
            reset_launches(cb, fa)
            for c in SERVE_CONC:
                engine._ttft_window = type(engine._ttft_window)(
                    window_s=3600.0)
                legs[f"batched_{tag}_c{c}"], outs = serve_sweep(
                    pred, SERVE_PROMPTS, c, names)
                require(all(o["completion_tokens"] > 0 for o in outs),
                        f"batched {tag} c{c}: a request generated nothing")
                if c == 8:
                    _, mean, p50, p99, n = engine._ttft_window.stats()
                    ttft[tag] = {"mean_s": mean, "p50_s": p50, "p99_s": p99,
                                 "n": n}
            batch_launches[tag] = launches(cb, fa)
            steps[tag] = engine.scheduler.steps_run - steps0
            require(engine.health()["status"] == "ok",
                    f"batched {tag}: engine {engine.health()}")
        finally:
            pred.close()
        require(not any(batch_launches[tag].values()),
                f"batch mode launched {batch_launches[tag]}: its attention "
                f"is cached_attention, no kernel")
    iso = isolation(torch, bundle, tok, bank64, DecodeScheduler, dev)
    top = max(SERVE_CONC)
    line = {"legs": legs, "ttft_c8": ttft, "decode_steps": steps,
            "b2_launches_single": single_launches["flash_fwd"],
            "single_forwards": forwards, "isolation": iso,
            "speedup_c64": legs[f"batched_bank1_c{top}"]["tokens_per_s"]
            / legs[f"sequential_c{top}"]["tokens_per_s"]}
    return line, single_launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        import fedml_tpu_torch as fedml
        from fedml_tpu_torch import llm
        from fedml_tpu_torch.arguments import Arguments
        from fedml_tpu_torch.core.kernels import build
        from fedml_tpu_torch.core.kernels import conv_block as cb
        from fedml_tpu_torch.core.kernels import flash_attention as fa
        from fedml_tpu_torch.llm import attention as attn
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
    spilled = build_all(build, ["conv_block", "flash_attention"])
    mma = {fn: n for fn, n in spilled.items() if "_mma_kernel" in fn}
    n_attn = sum("flash_" in fn for fn in mma)
    n_conv = sum("conv_block_mma_kernel" in fn for fn in mma)
    require(n_attn == 12 and n_conv == len(cb.MMA_WIDTHS) ** 2,
            f"expected 12 tensor-core instantiations of attention (B2, B3, "
            f"B4 x 4 head widths) and {len(cb.MMA_WIDTHS) ** 2} of B1 (cin x "
            f"cout), the compiler reported {mma}")
    require(not any(mma.values()), f"tensor-core kernels spill: {mma}")
    simt_bf16 = [fn for fn in spilled if "bfloat16" in fn and any(
        k in fn for k in ("conv_block_kernel", "flash_fwd_kernel",
                          "flash_dq_kernel", "flash_dkv_kernel"))]
    require(not simt_bf16, f"bf16 CUDA-core B1-B4 built: {simt_bf16}")

    gen = torch.Generator().manual_seed(0)
    main_err, main_err16 = 0.0, 0.0
    for dtype in ("float32", "bfloat16"):
        shapes = [(BATCH, h, h, cin, cout, s)
                  for (h, cin, cout, s), _ in FLAGSHIP] + ODD
        for shape in shapes:
            err, gerr, err16 = check_case(torch, cb, gen, shape, dtype)
            if dtype == MAIN_PATH["precision"] and shape[0] == BATCH:
                main_err = max(main_err, err)
                main_err16 = max(main_err16, err16)
            vs16 = "" if err16 is None else f" (plain bf16: {err16:.3e})"
            print(f"check {dtype:8s} n,h,w,cin,cout,s={shape}: max abs err "
                  f"{err:.3e}{vs16}, grad rel err {gerr:.3e}", flush=True)
    attn_err = {}
    for dtype in ("float32", "bfloat16"):
        for shape in ATTN_SHAPES:
            errs = check_attention(torch, fa, attn, gen, shape, dtype)
            if shape == ATTN_MAIN and dtype == "bfloat16":
                attn_err = dict(zip(("flash_fwd", "flash_dq", "flash_dkv"),
                                    errs))
            print(f"check {dtype:8s} attention b,s,h,d,mask={shape}: max abs "
                  f"err O {errs[0]:.3e}, dQ {errs[1]:.3e}, dK/dV "
                  f"{errs[2]:.3e}", flush=True)

    rows = time_geometries(torch, F, cb, gen, MAIN_PATH["precision"])
    for r in rows:
        print(f"time bf16 bs{BATCH} {r['geometry']} x{r['count']} (cluster "
              f"{r['cluster']}): kernel "
              f"{r['ms']:.4f} ms (device time {r['device_ms']:.4f} ms), "
              f"plain {r['plain_ms']:.4f} ms, cuDNN chain device time "
              f"{r['library_ms']:.4f} ms (events {r['library_event_ms']:.4f}"
              f" ms), bound {r['bound_ms']:.5f} ms ({r['bound_by']})",
              flush=True)
    per_fwd = {k: sum(r[k] * r["count"] for r in rows)
               for k in ("ms", "device_ms", "plain_ms", "library_ms",
                         "library_event_ms", "bytes_ms", "ops_ms")}
    # the 27 launches together: their bytes over the memory rate against
    # their operations over the peak
    per_fwd["bound_ms"] = max(per_fwd["bytes_ms"], per_fwd["ops_ms"])
    per_fwd["bound_by"] = ("bytes" if per_fwd["bytes_ms"] >= per_fwd["ops_ms"]
                           else "operations")
    print(f"time per ResNet-56 forward (27 blocks, bs{BATCH}, bf16): "
          f"kernel {per_fwd['ms']:.3f} ms (device time "
          f"{per_fwd['device_ms']:.3f} ms), plain {per_fwd['plain_ms']:.3f} "
          f"ms, cuDNN chain device time {per_fwd['library_ms']:.3f} ms "
          f"(events {per_fwd['library_event_ms']:.3f} ms), bound "
          f"{per_fwd['bound_ms']:.4f} ms ({per_fwd['bound_by']})", flush=True)
    attn_time = {}
    for label, shape in (("main", ATTN_MAIN), ("hot", ATTN_HOT)):
        attn_time[label] = time_attention(torch, F, fa, gen, shape,
                                          "bfloat16")
        for kernel, r in attn_time[label].items():
            print(f"time bf16 attention {kernel:3s} b,s,h,d={shape[:4]}: "
                  f"kernel {r['ms']:.4f} ms (device time {r['device_ms']:.4f}"
                  f" ms), plain {r['plain_ms']:.4f} ms, SDPA device time {r['library_ms']:.4f} ms"
                  f"{' (fwd)' if kernel == 'fwd' else ' (bwd: dQ+dK+dV)'}, "
                  f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})",
                  flush=True)

    worst, acc_gpu, acc_cpu = tiny_run_agreement(torch, fedml)
    print(f"tiny run (resnet20, f32): card vs CPU params within "
          f"{worst:.3f} of tolerance; test acc {acc_gpu} vs {acc_cpu}",
          flush=True)
    worst, loss_gpu, loss_cpu = tiny_llm_agreement(
        torch, llm.run_federated_llm, Arguments)
    print(f"tiny run (LoRA causal LM, f32, flash): card vs CPU adapters "
          f"within {worst:.3f} of tolerance; test loss {loss_gpu:.6f} vs "
          f"{loss_cpu:.6f}", flush=True)

    reset_launches(cb, fa)
    t0 = time.time()
    result = fedml.run_simulation(**MAIN_PATH)
    torch.cuda.synchronize()
    wall = time.time() - t0
    resnet_launches = launches(cb, fa)
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
    n_b1 = resnet_launches["conv_block"]
    require(n_b1 == 27 * forwards,
            f"kernel launched {n_b1} times, expected 27 x {forwards}")
    print(f"main path: {wall:.1f} s end to end, {wall / len(hist):.2f} s per "
          f"round (eval included), {n_b1} kernel launches = 27 x "
          f"{forwards} forward passes", flush=True)

    reset_launches(cb, fa)
    t0 = time.time()
    result = llm.run_federated_llm(Arguments(**LLM_MAIN_PATH))
    torch.cuda.synchronize()
    wall = time.time() - t0
    llm_launches = launches(cb, fa)
    hist = result["history"]
    for h in hist:
        print(f"FedLLM round {h['round']}: {h['round_time_s']:.2f} s, "
              f"{h['local_steps']} local steps, {h['eval_batches']} eval "
              f"batches, train_loss {h['train_loss']:.4f}, test_loss "
              f"{h['test_loss']:.4f}, test_acc {h['test_acc']:.4f}",
              flush=True)
        require(all(math.isfinite(h[k]) for k in (
            "train_loss", "train_acc", "test_acc", "test_loss")),
            f"FedLLM round {h['round']}: non-finite metrics")
    require(all(torch.isfinite(v).all().item()
                for v in result["params"].values()), "non-finite adapters")
    layers = LLM_MAIN_PATH["llm_num_layers"]
    steps = sum(h["local_steps"] for h in hist)
    evals = sum(h["eval_batches"] for h in hist)
    want = {"conv_block": 0, "flash_fwd": layers * (steps + evals),
            "flash_dq": layers * steps, "flash_dkv": layers * steps}
    require(llm_launches == want, f"FedLLM launches {llm_launches}, "
                                  f"expected {want}")
    print(f"FedLLM main path: {wall:.1f} s end to end, {wall / len(hist):.2f} "
          f"s per round (eval included), {steps} local steps and {evals} "
          f"eval batches; launches {llm_launches}", flush=True)

    # the serving path, on the adapter the FedLLM run just trained
    from fedml_tpu_torch.llm import kv_cache as kvc
    from fedml_tpu_torch.serving.batch import AdapterBank, DecodeScheduler
    from fedml_tpu_torch.serving.llm_template import CausalLMPredictor
    checks = {"cache_arithmetic_slots": cache_arithmetic(torch, kvc)}
    tiny = dict(dataset="llm_synth", model="causal_lm", random_seed=3,
                llm_hidden_size=32, llm_num_layers=2, llm_num_heads=2,
                llm_intermediate_size=64, llm_max_seq_len=64, lora_rank=0,
                llm_attention_impl="dense")
    checks["decode_vs_forward_f32_tiny"] = decode_vs_forward(
        torch, llm.build_llm_bundle, Arguments, DecodeScheduler,
        AdapterBank, tiny, None, "float32")
    checks["decode_vs_forward_bf16"] = decode_vs_forward(
        torch, llm.build_llm_bundle, Arguments, DecodeScheduler,
        AdapterBank, LLM_MAIN_PATH, result["params"], "bfloat16")
    checks["greedy_parity_parted"] = greedy_parity(
        torch, llm.build_llm_bundle, Arguments, CausalLMPredictor)
    print(f"serving checks: {json.dumps(checks)}", flush=True)
    t0 = time.time()
    serving, serve_launches = serving_phase(torch, llm, cb, fa, Arguments,
                                            result["params"])
    serving["checks"] = checks
    serving["wall_s"] = time.time() - t0
    for leg, r in serving["legs"].items():
        print(f"serving {leg}: {r['tokens_per_s']:.1f} tokens/s, p99 "
              f"{r['p99_latency_s']:.3f} s ({r['tokens']} tokens in "
              f"{r['wall_s']:.2f} s)", flush=True)
    print(json.dumps({"serving": serving}), flush=True)

    ms, losses, hot_launches, n_params = hot_loop(torch, llm, cb, fa)
    require(all(math.isfinite(x) for x in losses), "hot loop: non-finite loss")
    per = HOT_LOOP["num_layers"] * HOT_STEPS
    require(hot_launches == {"conv_block": 0, "flash_fwd": per,
                             "flash_dq": per, "flash_dkv": per},
            f"hot loop launches {hot_launches}, expected {per} of each "
            f"attention kernel")
    print(f"hot loop ({n_params / 1e6:.1f}M params, bs{HOT_BATCH} x seq "
          f"{HOT_LOOP['max_seq_len']}, bf16, flash): {ms:.2f} ms per SGD "
          f"step, losses {[round(x, 4) for x in losses]}; launches "
          f"{hot_launches}", flush=True)

    # round-shape fields, then the hot loop's shape (B2-B4 only)
    kernels = [{
        "name": "conv_block", "route": "cuda",
        "source": "fedml_tpu_torch/core/kernels/csrc/conv_block.cu",
        "replaces": "fedml_tpu/core/kernels/conv_block.py:144",
        "design": DESIGN["conv_block"],
        "launches": resnet_launches["conv_block"],
        "launches_serving": serve_launches["conv_block"],
        "max_abs_err": main_err,
        "max_abs_err_plain_bf16": main_err16,
        "ms": per_fwd["ms"], "plain_ms": per_fwd["plain_ms"],
        "bound_ms": per_fwd["bound_ms"], "bound_by": per_fwd["bound_by"],
        "library_ms": per_fwd["library_ms"],
        "device_ms": per_fwd["device_ms"],
        "clusters": {r["geometry"]: r["cluster"] for r in rows},
        "ms_hot": None, "device_ms_hot": None, "plain_ms_hot": None,
        "library_ms_hot": None, "bound_ms_hot": None,
        "bound_by_hot": None}]
    for name, key, line in (("flash_fwd", "fwd", 121), ("flash_dq", "dq", 176),
                            ("flash_dkv", "dkv", 213)):
        r, rh = attn_time["main"][key], attn_time["hot"][key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fedml_tpu_torch/core/kernels/csrc/flash_attention.cu",
            "replaces": f"fedml_tpu/llm/attention.py:{line}",
            "design": DESIGN[name],
            "launches": llm_launches[name],
            "launches_serving": serve_launches[name],
            "max_abs_err": attn_err[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "device_ms": r["device_ms"],
            "ms_hot": rh["ms"], "device_ms_hot": rh["device_ms"],
            "plain_ms_hot": rh["plain_ms"],
            "library_ms_hot": rh["library_ms"],
            "bound_ms_hot": rh["bound_ms"], "bound_by_hot": rh["bound_by"]})
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
