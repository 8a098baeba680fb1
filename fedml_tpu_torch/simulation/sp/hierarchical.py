"""Hierarchical FL: two-level (edge -> cloud) aggregation (counterpart
of ``fedml_tpu/simulation/sp/hierarchical.py``, ``federated_optimizer:
hierarchicalfl``).

Clients are partitioned into ``group_num`` groups (group ``g`` owns
clients ``g, g + G, g + 2G, ...``). Each global round runs
``group_comm_round`` FedAvg sub-rounds within each group over its sampled
members (key ``fold_in(fold_in(rng, round), g * 1000 + edge_round)``,
folded with the client), then averages the group models weighted by
their sample counts. Local training runs the optimizer's step program
(:class:`~fedml_tpu_torch.core.algframe.local_training.StepProgram`): on
a card one CUDA graph per run, captured at the first client and replayed
per step; on the CPU the same step body eagerly, bitwise the eager loop.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ... import prng
from ...core.algframe.local_training import batch_real_of, evaluate
from ...core.algframe.types import Params, TrainHyper
from ...core.collectives import average_trees
from ...optimizers.base import StepPrograms
from ..gpu.engine import load_params
from ..sampling import client_sampling, sampling_stream_from_args

logger = logging.getLogger(__name__)


class HierarchicalSimulator:
    """``group_num`` edge aggregators, ``group_comm_round`` edge rounds per
    global round."""

    def __init__(self, args, fed_dataset, bundle, optimizer, spec,
                 device: torch.device,
                 init_params: Optional[Dict[str, Any]] = None):
        self.args = args
        self.fed = fed_dataset
        self.opt = optimizer
        self.spec = spec
        self.device = device
        self.group_num = int(getattr(args, "group_num", 2) or 2)
        self.group_comm_round = int(getattr(args, "group_comm_round", 1) or 1)
        seed = int(getattr(args, "random_seed", 0))
        # split(PRNGKey(seed)) = (init, local-training stream), as JAX
        self.rng = prng.split(prng.PRNGKey(seed))[1]
        if init_params is None:
            self.params = bundle.init(torch.Generator().manual_seed(seed),
                                      device)
        else:
            self.params = load_params(bundle, init_params, device)
        self.batch_real = batch_real_of(fed_dataset.train.mask)
        self.train = fed_dataset.train.to(device)
        self.test = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in fed_dataset.test.items()}
        self.groups: List[List[int]] = [
            [c for c in range(fed_dataset.num_clients)
             if c % self.group_num == g]
            for g in range(self.group_num)]
        self.programs = StepPrograms(optimizer, self.params,
                                     optimizer.server_init(self.params),
                                     self.train.client(0))
        self.history: List[Dict[str, Any]] = []

    def _train_clients(self, params: Params, client_ids, round_key,
                       hyper: TrainHyper):
        updates, weights = [], []
        for cid in client_ids:
            out, _ = self.opt.local_train(
                params, {}, {}, self.train.client(cid),
                prng.fold_in(round_key, cid), hyper,
                batch_real=self.batch_real[cid], programs=self.programs)
            updates.append(out.update)
            weights.append(out.weight)
        weights = torch.stack(weights).float()
        agg = average_trees(updates, weights)
        return ({k: v + agg[k] for k, v in params.items()},
                float(weights.sum()))

    def run(self, comm_round: Optional[int] = None) -> Dict[str, Any]:
        args = self.args
        rounds = comm_round if comm_round is not None else int(args.comm_round)
        hyper = TrainHyper(learning_rate=float(args.learning_rate),
                           epochs=int(args.epochs))
        per_round = int(args.client_num_per_round)
        freq = int(getattr(args, "frequency_of_the_test", 5) or 5)
        t0 = time.time()
        for round_idx in range(rounds):
            sampled = set(int(c) for c in client_sampling(
                round_idx, self.fed.num_clients, per_round,
                random_seed=int(getattr(args, "random_seed", 0) or 0),
                stream=sampling_stream_from_args(args)))
            group_params, group_weights = [], []
            for g, members in enumerate(self.groups):
                active = [c for c in members if c in sampled]
                if not active:
                    continue
                gp, gw = self.params, 0.0
                for edge_round in range(self.group_comm_round):
                    key = prng.fold_in(prng.fold_in(self.rng, round_idx),
                                       g * 1000 + edge_round)
                    gp, gw = self._train_clients(gp, active, key, hyper)
                group_params.append(gp)
                group_weights.append(gw)
            self.params = average_trees(
                group_params,
                torch.tensor(group_weights, dtype=torch.float32,
                             device=self.device))
            rec: Dict[str, Any] = {"round": round_idx}
            # freq < 0: never evaluate in-loop
            if freq > 0 and (round_idx % freq == 0
                             or round_idx == rounds - 1):
                stats = evaluate(self.spec, self.params, self.test["x"],
                                 self.test["y"], self.test["mask"])
                n = max(float(stats["count"]), 1.0)
                rec["test_acc"] = float(stats["correct"]) / n
                logger.info("hierarchical round %d: acc=%.4f", round_idx,
                            rec["test_acc"])
            self.history.append(rec)
        last_eval = next((r for r in reversed(self.history)
                          if "test_acc" in r), {})
        return {"params": self.params, "history": self.history,
                "wall_time_s": time.time() - t0,
                "final_test_acc": last_eval.get("test_acc"),
                "rounds": rounds}
