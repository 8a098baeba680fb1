#!/usr/bin/env python3
"""How far two runs of ``chip_smoke.py`` phase 24's job part on the card,
and how far a different job lands: the readings behind phase 24 (c)'s
bitwise check of the agent's job against (b).

    python3 scripts/platform_spread.py [--jobs N] [--out FILE]

Every run trains ``chip_smoke.PLATFORM_PATH`` (written as a yaml) through
the port's ``cli train`` and is read as phase 24 (c) reads the agent's
job against (b): the largest param difference from the reference run
over the largest param update of the round. The reference is
``cli.main`` in this process under torch's default numerics, as (b) runs.

Spread (the same job): ``--jobs`` CLI subprocesses (``python -m
fedml_tpu_torch.cli train``, as the agent starts it); in this process the
reference again, with ``cudnn.deterministic`` on, with TF32 off in cuDNN,
and with ``cudnn.benchmark`` on (twice: each process times the
algorithms anew, so the second reads what a second process would).
Controls (another job): ``precision: float32``; ``fused_conv_block:
false`` (cuDNN's convolutions in place of B1). A run that fails is
recorded with its error and the rest go on. Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# name -> cuDNN knobs set over torch's defaults for an in-process run
SAME_JOB = {"in_process_again": {}, "deterministic": {"deterministic": True},
            "tf32_off": {"allow_tf32": False},
            "benchmark_1": {"benchmark": True},
            "benchmark_2": {"benchmark": True}}
# name -> config changes of a control run (torch's default numerics)
CONTROLS = {"float32": {"precision": "float32"},
            "unfused": {"fused_conv_block": False}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--jobs", type=int, default=3)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("platform_spread: no CUDA device available", file=sys.stderr)
        return 1
    import yaml

    import chip_smoke as cs
    from fedml_tpu_torch import cli, data, model
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core.kernels import build
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    cs.build_all(build, ["conv_block"])
    cfg = dict(cs.PLATFORM_PATH)
    out = {"card": card, "config": cfg, "runs": {}}
    with tempfile.TemporaryDirectory(prefix="platform_spread_") as tmp:
        art = os.path.join(tmp, "model.fmtpu")

        def job(name, changes=None):
            yml = os.path.join(tmp, f"{name}.yaml")
            with open(yml, "w") as f:
                yaml.safe_dump(dict(cfg, save_model_path=art,
                                    **(changes or {})), f)
            return yml

        def in_process(name, knobs=None, changes=None):
            yml = job(name, changes)
            t0 = time.perf_counter()
            with cs.torch_default_numerics(torch):
                for k, v in (knobs or {}).items():
                    setattr(torch.backends.cudnn, k, v)
                rc = cli.main(["train", "--cf", yml])
            cs.require(rc == 0, f"{name}: cli train exited {rc}")
            return keep(name, time.perf_counter() - t0)

        def keep(name, wall):
            path = os.path.join(tmp, f"{name}.fmtpu")
            os.replace(art, path)
            return cs._state_of(torch, path), wall

        ref, ref_s = in_process("reference")
        args = Arguments(**cfg)
        fed, n_classes = data.load(args)
        p0 = model.create(args, n_classes, fed.input_shape).init(
            torch.Generator().manual_seed(int(cfg["random_seed"])), "cpu")
        moved = max(float((ref[k] - p0[k].float()).abs().max())
                    for k in ref)
        out.update(update_max_abs=moved, reference_s=ref_s)

        def read(name, kind, state, wall):
            diff = max(float((state[k] - ref[k]).abs().max()) for k in ref)
            out["runs"][name] = {"kind": kind, "max_abs": diff,
                                 "of_update": diff / moved, "s": wall}
            print(f"{kind:<8} {name:<18} {diff:.6e} = "
                  f"{diff / moved:.6e} of the update ({wall:.1f} s)",
                  flush=True)

        def subprocess_job(name):
            yml = job(name)
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "fedml_tpu_torch.cli", "train",
                 "--cf", yml], cwd=ROOT,
                env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True,
                text=True, timeout=300)
            cs.require(r.returncode == 0,
                       f"{name} exited {r.returncode}:\n{r.stderr[-3000:]}")
            return keep(name, time.perf_counter() - t0)

        runs = ([(f"job_{i}", "same", subprocess_job)
                 for i in range(a.jobs)]
                + [(n, "same", lambda n, k=k: in_process(n, knobs=k))
                   for n, k in SAME_JOB.items()]
                + [(n, "control", lambda n, c=c: in_process(n, changes=c))
                   for n, c in CONTROLS.items()])
        failed = False
        for name, kind, run in runs:
            try:
                read(name, kind, *run(name))
            except Exception as e:  # noqa: BLE001 — record it, go on
                failed = True
                out["runs"][name] = {"kind": kind, "error": repr(e)}
                print(f"{kind:<8} {name:<18} FAILED {e!r}", flush=True)
    read_ = [r for r in out["runs"].values() if "of_update" in r]
    for kind in ("same", "control"):
        vals = [r["of_update"] for r in read_ if r["kind"] == kind]
        out[f"{kind}_max"] = max(vals, default=None)
        out[f"{kind}_min"] = min(vals, default=None)
    print(json.dumps({"platform_spread": out}, default=str))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
