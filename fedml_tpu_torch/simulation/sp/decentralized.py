"""Decentralized (gossip) FL with no server (counterpart of
``fedml_tpu/simulation/sp/decentralized.py``, ``federated_optimizer:
decentralized_fl``).

Every node starts from the same init. A round trains each node locally
(the optimizer's eager local SGD, key ``fold_in(fold_in(rng, round),
node)``), then mixes the stacked parameters with the topology's
row-stochastic matrix, ``P <- W @ P`` per leaf, in float32 and cast back
to each leaf's dtype. ``W`` comes from
:class:`~fedml_tpu_torch.core.distributed.topology.SymmetricTopologyManager`
(``topology_neighbors``, default 2). The message-passing form of the same
protocol is :mod:`fedml_tpu_torch.cross_silo.decentralized`.
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
from ...core.collectives import stack_trees
from ...core.distributed.topology import SymmetricTopologyManager
from ..gpu.engine import load_params

logger = logging.getLogger(__name__)


def mixing_matrix(args, n: int) -> np.ndarray:
    """The session's ``[n, n]`` row-stochastic gossip matrix."""
    tm = SymmetricTopologyManager(
        n, neighbor_num=int(getattr(args, "topology_neighbors", 2) or 2))
    tm.generate_topology()
    return np.asarray(tm.mixing_matrix())


def node_average(stacked: Params) -> Params:
    """The average model of stacked node params (mean over axis 0)."""
    return {k: v.mean(0) for k, v in stacked.items()}


def consensus_distance(stacked: Params) -> float:
    """Mean over nodes of each node's L2 distance to the average model:
    gossip drives it toward 0."""
    total = None
    for v in stacked.values():
        sq = ((v - v.mean(0, keepdim=True)) ** 2).reshape(
            v.shape[0], -1).sum(1)
        total = sq if total is None else total + sq
    return float(torch.sqrt(total).mean())


class DecentralizedSimulator:
    def __init__(self, args, fed_dataset, bundle, optimizer, spec,
                 device: torch.device,
                 init_params: Optional[Dict[str, Any]] = None):
        self.args = args
        self.fed = fed_dataset
        self.opt = optimizer
        self.spec = spec
        self.device = device
        self.n = fed_dataset.num_clients
        self.mixing = torch.as_tensor(mixing_matrix(args, self.n),
                                      dtype=torch.float32, device=device)
        seed = int(getattr(args, "random_seed", 0))
        # split(PRNGKey(seed)) = (init, local-training stream), as JAX
        self.rng = prng.split(prng.PRNGKey(seed))[1]
        if init_params is None:
            p0 = bundle.init(torch.Generator().manual_seed(seed), device)
        else:
            p0 = load_params(bundle, init_params, device)
        self.node_params = stack_trees(p0, self.n)
        self.batch_real = batch_real_of(fed_dataset.train.mask)
        self.train = fed_dataset.train.to(device)
        self.test = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in fed_dataset.test.items()}
        self.history: List[Dict[str, Any]] = []

    def _round(self, round_idx: int, hyper: TrainHyper) -> None:
        round_key = prng.fold_in(self.rng, round_idx)
        trained = []
        for cid in range(self.n):
            params = {k: v[cid] for k, v in self.node_params.items()}
            out, _ = self.opt.local_train(
                params, {}, {}, self.train.client(cid),
                prng.fold_in(round_key, cid), hyper,
                batch_real=self.batch_real[cid])
            trained.append({k: params[k] + out.update[k] for k in params})
        # gossip mixing: P <- W @ P per leaf, in float32
        self.node_params = {
            k: torch.tensordot(
                self.mixing, torch.stack([t[k] for t in trained]).float(),
                dims=1).to(v.dtype)
            for k, v in self.node_params.items()}

    def run(self, comm_round: Optional[int] = None) -> Dict[str, Any]:
        args = self.args
        rounds = comm_round if comm_round is not None else int(args.comm_round)
        hyper = TrainHyper(learning_rate=float(args.learning_rate),
                           epochs=int(args.epochs))
        freq = int(getattr(args, "frequency_of_the_test", 5) or 5)
        t0 = time.time()
        for round_idx in range(rounds):
            self._round(round_idx, hyper)
            rec: Dict[str, Any] = {"round": round_idx}
            if round_idx % freq == 0 or round_idx == rounds - 1:
                stats = evaluate(self.spec, node_average(self.node_params),
                                 self.test["x"], self.test["y"],
                                 self.test["mask"])
                n = max(float(stats["count"]), 1.0)
                rec["test_acc"] = float(stats["correct"]) / n
                rec["consensus_dist"] = consensus_distance(self.node_params)
                logger.info("gossip round %d: acc=%.4f consensus=%.4f",
                            round_idx, rec["test_acc"], rec["consensus_dist"])
            self.history.append(rec)
        last_eval = next(r for r in reversed(self.history) if "test_acc" in r)
        return {"params": node_average(self.node_params),
                "node_params": self.node_params,
                "history": self.history, "wall_time_s": time.time() - t0,
                "final_test_acc": last_eval["test_acc"], "rounds": rounds}
