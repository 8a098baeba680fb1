#!/usr/bin/env python3
"""Three measurements behind ``chip_smoke.py`` phase 23's design, two on
the card (f32 with TF32 off) and one on the CPU:

    python3 scripts/tail_probe.py [wgrad] [femnist] [drift] [--out FILE]

``wgrad``: the filter gradient of LeNet-5's stem (1 input channel, 5x5
SAME, 6 outputs, batch 8 of 28x28) through ``conv2d`` on the card under
each cuDNN setting (deterministic, benchmark; the input as the port lays
it out and contiguous), with cuDNN off, and as LeNet's im2col GEMM
(``model/cv/lenet.py::conv_gemm``), and on the CPU: each one's largest
error against a float64 reference on the CPU, beside that reference's
largest entry.

``femnist``: ``bench_hierarchical_femnist``'s configuration
(``chip_smoke.TAIL_FEMNIST``) for one warm-up and one timed global round
with the local steps replayed from the captured step program (the
simulator's path) and run eagerly (``run_local_sgd``): seconds per
global round each. Needs a CUDA card.

``drift``: on the CPU, each protocol of phase 23 (b)
(``chip_smoke.TAIL_PROTOCOLS``, and FedGAN on its full 4,000 samples)
from its initial parameters and from them each moved one ulp up: the
params and history after each round over the house tolerance, as
phase 23 (b) compares the card with the CPU. It shows how deep a
comparison stays inside the tolerance before training's own
amplification of rounding leaves it. Needs no card.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def wgrad(torch):
    import torch.nn.functional as F

    from fedml_tpu_torch.model.cv.lenet import conv_gemm
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 28, 28, 1, generator=g)
    w = torch.randn(5, 5, 1, 6, generator=g) * 0.2
    cot = torch.randn(8, 28, 28, 6, generator=g)

    def grad(dev, dt, how, det=False, bench=False, enabled=True):
        with torch.backends.cudnn.flags(enabled=enabled, benchmark=bench,
                                        deterministic=det, allow_tf32=False):
            ww = w.to(dev, dt).requires_grad_()
            xx = x.to(dev, dt)
            if how == "gemm":
                y = conv_gemm(xx, ww, ((2, 2), (2, 2)))
            else:
                xn = F.pad(xx.permute(0, 3, 1, 2), (2, 2, 2, 2))
                if how == "contiguous":
                    xn = xn.contiguous()
                y = F.conv2d(xn, ww.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
            g, = torch.autograd.grad((y * cot.to(dev, dt)).sum(), [ww])
        return g.double().cpu()

    ref = grad("cpu", torch.float64, "port")
    out = {"largest_entry": ref.abs().max().item()}
    cases = {"cpu": ("cpu", "port", {}), "cpu_gemm": ("cpu", "gemm", {}),
             "card_gemm": ("cuda", "gemm", {}),
             "card_cudnn_off": ("cuda", "port", {"enabled": False})}
    for how in ("port", "contiguous"):
        for det in (False, True):
            for bench in (False, True):
                cases[f"card_cudnn_{how}_det{int(det)}_bench{int(bench)}"] = (
                    "cuda", how, {"det": det, "bench": bench})
    for name, (dev, how, kw) in cases.items():
        out[name] = (grad(dev, torch.float32, how, **kw) - ref).abs().max(
        ).item()
    return out


def femnist(torch):
    import chip_smoke as c
    out = {}
    for path in ("captured", "eager"):
        runner = c._tail_runner(c.TAIL_FEMNIST, "cuda")
        sim = runner.runner
        if path == "eager":
            sim.programs = None       # local_train's eager loop
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            sim.run(comm_round=1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[path] = {"warmup_round_s": times[0], "round_s": times[1]}
    return out


def _one_ulp_up(torch, sim, name):
    """A protocol simulator's initial parameters as its ``init_params``,
    each float moved one ulp up (``torch.nextafter``)."""
    import math
    up = lambda p: {k: torch.nextafter(  # noqa: E731
        v, torch.full_like(v, math.inf)) for k, v in p.items()}
    if name == "FedGKT":
        return {"edge": [up(e) for e in sim.edge_params],
                "head": up(sim.head_params)}
    if name == "FedNAS":
        return {"params": up(sim.params),
                "alphas": up({"a": sim.alphas})["a"]}
    if name == "FedGAN":
        return {"gen": up(sim.gen_params), "disc": up(sim.disc_params)}
    return up(sim.params)


def drift(torch):
    import chip_smoke as c
    cfgs = dict(c.TAIL_PROTOCOLS)
    full = dict(cfgs["FedGAN"])
    full.pop("max_total_samples")
    out = {}
    for tag, cfg in list(cfgs.items()) + [("FedGAN_4000", full)]:
        name = tag.split("_")[0]
        ref, sr, _ = c._tail_rounds(torch, cfg, "cpu", name)
        init = _one_ulp_up(torch, c._tail_runner(cfg, "cpu").runner, name)
        got, sg, _ = c._tail_rounds(torch, cfg, "cpu", name, init)
        out[tag] = [c._tail_drift(torch, name, cfg, got, ref, sg, sr, k)
                    for k in range(1, len(sr) + 1)]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("probes", nargs="*",
                   choices=("wgrad", "femnist", "drift"))
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    probes = a.probes or ["wgrad", "femnist"]
    import torch
    card = any(name != "drift" for name in probes)
    if card and not torch.cuda.is_available():
        print("tail_probe: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as c
    out = {"card": c.card_line() if card else None}
    for name in probes:
        out[name] = {"wgrad": wgrad, "femnist": femnist,
                     "drift": drift}[name](torch)
        print(f"{name}: {json.dumps(out[name])}", flush=True)
    print(json.dumps(out))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
