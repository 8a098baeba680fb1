#!/usr/bin/env python3
"""Which collectives a gloo group of two ranks on one CUDA card runs on CUDA
tensors: each operation in a fresh pair of rank processes
(``core/launch.py::run_ranks``), so a rank that dies in native code
(a segmentation fault) fails that operation alone.

    python3 scripts/gloo_cuda_probe.py [op ...]

Operations: ``all_reduce``, ``all_gather``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_to_all_single_f32`` / ``_bf16`` /
``_int8`` (``torch.distributed`` on CUDA tensors), ``all_to_all_tiled``
and ``all_gather_tiled`` (the port's ``core/collectives.py`` wrappers the
robust round's relayout uses, with the bytes they counted),
``ring_shift`` (the port's point-to-point step, staged through host
memory), ``dtensor_gather`` (DTensor's redistribute ``Shard -> Replicate``
of a CUDA tensor) and ``dtensor_reduce_scatter`` (its backward ``Partial
-> Shard``). Prints one line per operation: its ranks' results, or the end
of the failing rank's log. Needs a CUDA card.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

OPS = ("all_reduce", "all_gather", "all_gather_into_tensor",
       "reduce_scatter_tensor", "all_to_all_single_f32",
       "all_to_all_single_bf16", "all_to_all_single_int8",
       "all_to_all_tiled", "all_gather_tiled", "ring_shift",
       "dtensor_gather", "dtensor_reduce_scatter")


def op(name):
    """One rank's part of operation ``name``; returns what it received."""
    import torch
    import torch.distributed as dist
    from fedml_tpu_torch.core.mesh import build_mesh, init_ranks
    init_ranks()
    r = dist.get_rank()
    x = torch.full((1000,), float(r + 1), device="cuda")
    if name == "all_reduce":
        dist.all_reduce(x)
        return float(x[0])
    if name == "all_gather":
        out = [torch.zeros_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(out, x)
        return [float(o[0]) for o in out]
    if name == "all_gather_into_tensor":
        out = x.new_zeros(x.numel() * dist.get_world_size())
        dist.all_gather_into_tensor(out, x)
        return [float(out[0]), float(out[-1])]
    if name == "reduce_scatter_tensor":
        out = x.new_zeros(x.numel() // dist.get_world_size())
        dist.reduce_scatter_tensor(out, x)
        return float(out[0])
    if name.startswith("all_to_all_single_"):
        dt = {"f32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8}[name.rsplit("_", 1)[1]]
        src = (torch.arange(8, device="cuda") + 10 * r).to(dt)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src)
        return out.float().tolist()
    if name in ("all_to_all_tiled", "all_gather_tiled"):
        from fedml_tpu_torch.core import collectives
        collectives.reset_collective_stats()
        if name == "all_to_all_tiled":
            got = collectives.all_to_all_tiled(
                torch.arange(8.0, device="cuda").reshape(2, 4) + 10 * r,
                None)
        else:
            got = collectives.all_gather_tiled(x[:2].to(torch.int8), None)
        return {"out": got.float().tolist(), "device": str(got.device),
                "stats": collectives.collective_stats()}
    if name == "ring_shift":
        from fedml_tpu_torch.core.collectives import ring_shift
        return float(ring_shift([x], None)[0][0])
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    mesh = build_mesh({"fsdp": dist.get_world_size()})
    p = distribute_tensor(torch.arange(8.0, device="cuda").reshape(4, 2),
                          mesh, [Shard(0)])
    if name == "dtensor_gather":
        return p.redistribute(mesh, [Replicate()]).to_local().tolist()
    p.requires_grad_(True)
    full = p.redistribute(mesh, [Replicate()]).to_local(
        grad_placements=[Partial()])
    (full * (r + 1)).sum().backward()
    return p.grad.to_local().tolist()


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device available", file=sys.stderr)
        return 1
    from fedml_tpu_torch.core.launch import run_ranks
    for name in argv or OPS:
        try:
            got = run_ranks("scripts.gloo_cuda_probe:op", 2, {"name": name},
                            timeout=120.0, threads=2)
        except (RuntimeError, TimeoutError) as e:
            got = "FAILED: " + str(e)[-1500:]
        print(f"{name}: {got}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
