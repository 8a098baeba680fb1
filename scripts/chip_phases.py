#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s phases alone on the card, after building
the kernels, with the script's checks.

    python3 scripts/chip_phases.py roofline cross_device [--out FILE]

``roofline`` is phase 20 (the compute plane), ``cross_device`` phase 21,
``multi_rank`` phase 22 (the port's ranks on the one card), ``tail``
phase 23 (the long tail of training: the new models, FedGKT / FedNAS /
FedSeg / FedGAN, hierarchical FEMNIST, turbo_aggregate and centralized),
``platform`` phase 24 (env and diagnosis, ``cli train``, a job through an
agent, ``api.model_serve``).
A phase that fails prints its traceback and the run goes on to the next;
the exit code is 1 if any failed. ``--out`` writes every phase's record
(or traceback) as JSON. Needs a CUDA card, as ``chip_smoke.py`` does.
"""

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("phases", nargs="+", choices=("roofline",
                                                 "cross_device",
                                                 "multi_rank", "tail",
                                                 "platform"))
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from fedml_tpu_torch import llm
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core.kernels import build
    from fedml_tpu_torch.core.kernels import conv_block as cb
    from fedml_tpu_torch.core.kernels import flash_attention as fa
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    cs.build_all(build, ["conv_block", "flash_attention"])
    out, failed = {}, False
    with tempfile.TemporaryDirectory(prefix="chip_phases_") as tmp:
        run = {"roofline": lambda: cs.roofline_phase(
                   torch, llm, cb, fa, Arguments, card)[0],
               "cross_device": lambda: cs.cross_device_phase(
                   torch, cb, fa, tmp, card),
               "multi_rank": lambda: cs.multi_rank_phase(
                   torch, cb, fa, card),
               "tail": lambda: cs.tail_phase(torch, cb, fa, card),
               "platform": lambda: cs.platform_phase(torch, cb, fa, card,
                                                     tmp)}
        for name in a.phases:
            t0 = time.perf_counter()
            try:
                out[name] = run[name]()
                print(f"{name}: ok in {time.perf_counter() - t0:.1f} s",
                      flush=True)
            except Exception:
                failed = True
                out[name] = traceback.format_exc()
                print(f"{name}: FAILED\n{out[name]}", flush=True)
    print(json.dumps(out, default=str))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
