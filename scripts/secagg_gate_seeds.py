"""How the SecAgg wire leg's acceptance depends on the initial model.

The leg (bench.py's ``_secagg_wire_leg``; ``chip_smoke.secagg_wire_leg``
in the port) accepts when the 4-bit lane leg reaches 90 % test accuracy
within +-2 rounds of the dense field leg. Both legs start from one LR
init, so the gap is a property of that draw as much as of the code. This
script runs the leg on the CPU for several init seeds (the data, the
local keys and the lane rounding stay the bench's) and prints, per seed,
rounds to 90 % for both legs, their gap and whether the gate passes.

    python scripts/secagg_gate_seeds.py --impl port --seeds 0 1 2 3 4 5
    python scripts/secagg_gate_seeds.py --impl jax --seeds 0 1 2 3 4 5

``--impl port`` runs the port's leg twice per seed: from the port's own
init (``bundle.init`` seeded by ``torch.Generator``) and from the bench's
flax init (``chip_smoke.bench_lr_init``, bit-equal to the JAX package's
init for that seed). It imports nothing of JAX. ``--impl jax`` runs
bench.py's own leg, whose init seed is fixed at 0 there: the script
replaces that ``PRNGKey(0)`` with ``PRNGKey(seed)`` (the local keys are
``PRNGKey(17 + silo)``, so seeds 17-20 are refused). Each prints one JSON
object per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _row(seed, init, rec):
    a, b = rec["rounds_to_target"], rec["dense_field_rounds_to_target"]
    gap = None if None in (a, b) else a - b
    return {"seed": seed, "init": init, "lane_rounds": a, "dense_rounds": b,
            "gap": gap, "gate_passes": gap is not None and abs(gap) <= 2,
            "lane_acc": rec["final_acc"],
            "dense_acc": rec["dense_field_final_acc"],
            "mask_sum_bit_exact": rec["mask_sum_bit_exact"]}


def run_port(seeds):
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as c

    with tempfile.TemporaryDirectory() as tmp:
        _, _, bundle = c._parts(dict(c.SECAGG_WIRE, data_cache_dir=tmp),
                                training_type="cross_silo")
        for seed in seeds:
            own = {k: v.detach() for k, v in bundle.init(
                torch.Generator().manual_seed(seed), "cpu").items()}
            fan_out, fan_in = own["Dense_0.weight"].shape
            for name, init in (("port", own), ("bench", c.bench_lr_init(
                    seed, fan_in, fan_out))):
                rec = c.secagg_wire_leg(torch, tmp, dev="cpu", init=init,
                                        gate=False)
                print(json.dumps(_row(seed, name, rec)), flush=True)


def run_jax(seeds):
    import jax

    sys.path.insert(0, ROOT)
    import bench

    for seed in seeds:
        if 17 <= seed <= 20:
            raise SystemExit(f"seed {seed} collides with a silo's key")
        orig = jax.random.PRNGKey

        def key(s, _seed=seed, _orig=orig):
            return _orig(_seed if int(s) == 0 else s)

        jax.random.PRNGKey = key
        try:
            rec = bench._secagg_wire_leg()
        finally:
            jax.random.PRNGKey = orig
        print(json.dumps(_row(seed, "jax_bench", rec)), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", choices=("port", "jax"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4,
                                                             5])
    a = ap.parse_args()
    (run_port if a.impl == "port" else run_jax)(a.seeds)


if __name__ == "__main__":
    main()
