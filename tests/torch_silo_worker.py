"""One rank of a two-rank hierarchical silo on the CPU (gloo), for
``tests/test_torch_hierarchical.py``.

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_silo_worker.py <cfg.json> <out.npz>

Joins the silo's process group through ``init_silo_process_group``; rank
0 trains silo client 0 for round 0 (and client 1 for round 1) from the
seeded init and writes the trained parameters to ``out.npz``; rank 1
follows its trainings. Both leave the group before they exit.
"""

import json
import sys

import numpy as np
import torch


def main(cfg_path, out_path):
    torch.set_num_threads(1)
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core.algframe.client_trainer import \
        make_trainer_spec
    from fedml_tpu_torch.cross_silo.hierarchical import (
        HierarchicalSiloTrainer, close_silo_process_group,
        init_silo_process_group)
    from fedml_tpu_torch.optimizers.registry import create_optimizer

    with open(cfg_path) as f:
        cfg = json.load(f)
    assert init_silo_process_group(device="cpu")
    args = Arguments(**cfg)
    fed, od = data.load(args)
    bundle = model.create(args, od, fed.input_shape)
    spec = make_trainer_spec(fed, bundle)
    trainer = HierarchicalSiloTrainer(args, fed, bundle, spec,
                                      create_optimizer(args, spec), "cpu")
    assert trainer.world == 2
    if trainer.silo_rank != 0:
        assert trainer.follow() == 2
        close_silo_process_group()
        return
    out = {}
    params = trainer.params_template
    for rnd, cid in ((0, 0), (1, 1)):
        params, n, metrics = trainer.train(params, cid, rnd)
        out.update({f"r{rnd}.{k}": v.numpy() for k, v in params.items()})
        out[f"r{rnd}.train_loss"] = np.float64(metrics["train_loss"])
    trainer.release()
    close_silo_process_group()
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
