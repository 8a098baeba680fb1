#!/usr/bin/env python3
"""The schedule of ``chip_smoke.py``'s full-width async legs (phase 10
(b)), replayed on the CPU without the model.

    python3 scripts/async_schedule.py [ms_per_step ...]

An async pour's schedule — who is dispatched, who drops or straggles,
when each update arrives, what each pour takes in and how many local
steps each client runs — depends on the seeds, the chaos plan, K and each
client's real batches, never on the model's numbers. So this builds the
legs' federated dataset from its labels alone (the synthetic CIFAR-10
generator's label draws and the hetero partition; every image a single
zero feature), runs the port's async engine with a linear model on the
CPU, and prints, per leg, the bootstrap's and each timed pour's steps,
poured updates, staleness, dispatched / dropped / straggling clients and
the virtual clock, then the B1 launches the card must count (27 × (3
warm-up + steps)) and, for each given ``ms_per_step``, the seconds per
timed pour and the updates per wall hour that step time gives.
"""
import json
import os
import sys
import zlib

import numpy as np
import torch

root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, root)
import chip_smoke as c                                          # noqa: E402
from fedml_tpu_torch import model                               # noqa: E402
from fedml_tpu_torch.arguments import Arguments                 # noqa: E402
from fedml_tpu_torch.core.algframe.types import TrainHyper      # noqa: E402
from fedml_tpu_torch.data.containers import from_central_arrays  # noqa: E402
from fedml_tpu_torch.runner import FedMLRunner                  # noqa: E402


def label_only_dataset(cfg):
    """The legs' partition and masks with one zero feature per image: the
    generator's RandomState draws the prototypes, then the labels."""
    n_train, n_test = cfg["synthetic_size"], cfg["synthetic_test_size"]
    seed = cfg["random_seed"]
    rng = np.random.RandomState(seed + zlib.crc32(b"cifar10") % 1000)
    rng.randn(10, 32 * 32 * 3)
    y = rng.randint(0, 10, size=n_train + n_test).astype(np.int32)
    x = np.zeros((n_train + n_test, 1), np.float32)
    # the loader's slicing: train first, the test set last
    return from_central_arrays(
        x[:-n_test], y[:-n_test], x[-n_test:], y[-n_test:],
        cfg["client_num_in_total"], cfg["batch_size"], 10, "hetero", 0.5,
        seed)


def replay(leg, cfg, n_pours, ms_per_step):
    cfg = dict(cfg, model="lr", precision="float32", fused_conv_block="")
    args = Arguments(**cfg)
    fed = label_only_dataset(cfg)
    bundle = model.create(args, 10, fed.input_shape)
    sim = FedMLRunner(args, device="cpu", dataset=fed, model=bundle).runner
    hyper = TrainHyper(learning_rate=cfg["learning_rate"], epochs=1)
    sim._bootstrap(hyper)
    boot = dict(sim.async_stats)
    pours = []
    for _ in range(n_pours):
        before = dict(sim.async_stats)
        r = sim._pour_step(hyper)
        pours.append({"poured": r["poured"], "steps": r["local_steps"],
                      "staleness_mean": r["staleness_mean"],
                      "staleness_max": r["staleness_max"],
                      "virtual_t": sim.virtual_t,
                      **{k: sim.async_stats[k] - before[k]
                         for k in ("dispatched", "dropped", "stragglers")}})
    timed = sum(p["steps"] for p in pours)
    poured = sum(p["poured"] for p in pours)
    rec = {"leg": leg, "bootstrap": boot, "pours": pours,
           "timed_steps": timed, "poured": poured,
           "b1_launches": 27 * (3 + sim.async_stats["local_steps"]),
           "updates_per_sim_hour": (3600.0 * sim.updates_aggregated
                                    / sim.virtual_t),
           "predicted": {str(ms): {
               "s_per_pour": timed * ms / 1e3 / n_pours,
               "bootstrap_s": boot["local_steps"] * ms / 1e3,
               "updates_per_wall_hour": 3600.0 * poured / (timed * ms / 1e3)}
               for ms in ms_per_step}}
    if sim._defended:
        rec["byzantine_poured"] = sum(
            int(np.sum(np.asarray(sim.attacker.byzantine_mask(
                np.asarray(ids))) > 0)) for ids, _ in sim.verdicts.values())
    return rec


if __name__ == "__main__":
    torch.set_num_threads(1)
    steps_ms = [float(a) for a in sys.argv[1:]] or [11.5, 12.0]
    for leg, cfg, n in c.ASYNC_LEGS:
        print(json.dumps(replay(leg, cfg, n, steps_ms)), flush=True)
