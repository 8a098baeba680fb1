"""Asynchronous FedAvg: staleness-weighted server merges (counterpart of
``fedml_tpu/simulation/sp/async_fedavg.py``, ``federated_optimizer:
Async_FedAvg``).

The server merges each arriving client model immediately, down-weighted by
its staleness, and re-dispatches the client slot with the current global
model. Client speeds are the seeded per-client durations of
``core/async_rounds/arrivals.py``; an event queue orders the arrivals.
Local training is the eager loop (no captured step), as in the SP golden
loop.

Merge rule (FedAsync, Xie et al.): ``w <- w + a_t * (w_k - w_base)`` with
``a_t = alpha * s(t - t_k)``, ``s`` the shared staleness-decay family of
``core/async_rounds`` (polynomial by default; constant and hinge ride the
same knobs as ``round_mode: async_buffered``).
"""

from __future__ import annotations

import heapq
import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ... import prng
from ...core.algframe.local_training import batch_real_of, evaluate
from ...core.algframe.types import TrainHyper
from ...core.async_rounds import (durations_from_args, merge_alpha_from_args,
                                  staleness_fn_from_args)
from ..gpu.engine import load_params

logger = logging.getLogger(__name__)


class AsyncFedAvgSimulator:
    def __init__(self, args, fed_dataset, bundle, optimizer, spec,
                 device: torch.device,
                 init_params: Optional[Dict[str, Any]] = None):
        self.args = args
        self.fed = fed_dataset
        self.opt = optimizer
        self.spec = spec
        self.device = device
        self.alpha = merge_alpha_from_args(args)
        self.staleness_fn = staleness_fn_from_args(args)
        seed = int(getattr(args, "random_seed", 0))
        # split(PRNGKey(seed)) = (init, merge stream), as the JAX loop
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
        # per-client simulated round duration: heterogeneous, drawn from
        # the shared seeded arrival model (a pure function of the seed)
        self.durations = durations_from_args(fed_dataset.num_clients, args)
        self.history: List[Dict[str, Any]] = []

    def _evaluate(self) -> Dict[str, float]:
        stats = evaluate(self.spec, self.params, self.test["x"],
                         self.test["y"], self.test["mask"])
        n = max(float(stats["count"]), 1.0)
        return {"test_acc": float(stats["correct"]) / n}

    def run(self, comm_round: Optional[int] = None) -> Dict[str, Any]:
        args = self.args
        total_merges = (comm_round if comm_round is not None
                        else int(args.comm_round))
        hyper = TrainHyper(learning_rate=float(args.learning_rate),
                           epochs=int(args.epochs))
        n_clients = self.fed.num_clients
        concurrency = min(int(args.client_num_per_round), n_clients)
        t0 = time.time()
        # event queue: (finish_time, client_id, version_at_dispatch, seq,
        # params_snapshot) — clients train on the model they were HANDED,
        # not the current one, or staleness is fictitious; seq keeps the
        # heap off the snapshot
        queue: List = []
        version = 0
        for cid in range(concurrency):
            heapq.heappush(queue, (self.durations[cid], cid, version, cid,
                                   self.params))
        seq = next_cid = concurrency
        merges = 0
        freq = int(getattr(args, "frequency_of_the_test", 5) or 5)
        while merges < total_merges and queue:
            now, cid, dispatched_version, _, dispatched = heapq.heappop(
                queue)
            key = prng.fold_in(prng.fold_in(self.rng, merges), cid)
            out, _ = self.opt.local_train(
                dispatched, {}, {}, self.train.client(cid), key, hyper,
                batch_real=self.batch_real[cid])
            staleness = version - dispatched_version
            a_t = float(np.float32(
                self.alpha * float(self.staleness_fn(staleness))))
            self.params = {k: p + a_t * out.update[k]
                           for k, p in self.params.items()}
            version += 1
            merges += 1
            # redispatch: round-robin over all clients
            cid2 = next_cid % n_clients
            next_cid += 1
            heapq.heappush(queue, (now + self.durations[cid2], cid2, version,
                                   seq, self.params))
            seq += 1
            rec: Dict[str, Any] = {"round": merges - 1,
                                   "staleness": int(staleness)}
            if (merges - 1) % freq == 0 or merges == total_merges:
                rec.update(self._evaluate())
                logger.info("async merge %d (staleness %d): acc=%.4f",
                            merges - 1, staleness, rec["test_acc"])
            self.history.append(rec)
        last_eval = next(r for r in reversed(self.history) if "test_acc" in r)
        return {"params": self.params, "history": self.history,
                "wall_time_s": time.time() - t0,
                "final_test_acc": last_eval["test_acc"],
                "rounds": merges}
