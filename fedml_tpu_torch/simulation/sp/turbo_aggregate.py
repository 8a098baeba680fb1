"""TurboAggregate, group-ring secure aggregation (counterpart of
``fedml_tpu/simulation/sp/turbo_aggregate.py``, ``federated_optimizer:
turbo_aggregate``).

FedAvg whose aggregation runs through the group ring: the round's
sampled clients (``RandomState(300 + r)``) train locally with the inner
FedAvg optimizer (key ``fold_in(fold_in(rng, r), cid)``); client ``i``
joins group ``i % turbo_groups``. Each update, in the JAX flat layout and
scaled by its weight share, is quantized to GF(2^31 - 1) at
``secagg_scale`` (2^16); each member masks it with pairwise-cancelling
PRG streams inside its group; a group adds its partial sum onto the
running aggregate it receives and passes it on; the ring's output
dequantizes to the FedAvg aggregate (to one quantum per client), which
the optimizer's ``server_update`` applies.

:func:`_quantize`, :func:`_dequantize_sum` and :func:`_prg_mask` are the
JAX package's host numpy, copied: given the same updates the aggregate
equals its bit for bit. Local training runs the optimizer's step program
(:class:`~fedml_tpu_torch.core.algframe.local_training.StepProgram`):
one CUDA graph per run on a card, replayed per step; eager on the CPU.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ... import prng
from ...core.algframe.local_training import batch_real_of, evaluate
from ...core.algframe.types import TrainHyper
from ...core.collectives import tree_flatten_to_vector, vector_to_tree_like
from ...optimizers.base import StepPrograms
from ..gpu.engine import load_params

logger = logging.getLogger(__name__)

PRIME = np.uint64(2147483647)  # 2^31 - 1, the field of core/mpc


def _quantize(v: np.ndarray, scale: float) -> np.ndarray:
    half = np.int64(int(PRIME) // 2)
    q = np.clip(np.rint(v.astype(np.float64) * scale), -half, half - 1)
    return ((q + half) % np.int64(int(PRIME))).astype(np.uint64)


def _dequantize_sum(f: np.ndarray, n_terms: int, scale: float) -> np.ndarray:
    p = np.int64(int(PRIME))
    half = p // 2
    shifted = (f.astype(np.int64) - (n_terms * half) % p) % p
    signed = np.where(shifted > half, shifted - p, shifted)
    return signed.astype(np.float64) / scale


def _prg_mask(n: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(
        0, int(PRIME), size=n, dtype=np.uint64)


def ring_aggregate(updates: List[np.ndarray], weights: List[float],
                   round_idx: int, groups: int, scale: float) -> np.ndarray:
    """The group ring over float64 flat updates: masks cancel inside each
    group, the ring carries only partial sums; returns the dequantized
    weighted mean (float64)."""
    n = len(updates)
    dim = updates[0].size
    total_w = sum(weights) or 1.0
    p = np.uint64(int(PRIME))
    running = np.zeros(dim, np.uint64)
    n_terms = 0
    for g in range(groups):
        members = [i for i in range(n) if i % groups == g]
        partial = np.zeros(dim, np.uint64)
        for idx, i in enumerate(members):
            q = _quantize(updates[i] * (weights[i] / total_w), scale)
            # member j adds +mask(j, j+1) and -mask(j-1, j): a ring
            # within the group
            nxt = members[(idx + 1) % len(members)]
            prv = members[(idx - 1) % len(members)]
            if len(members) > 1:
                m_add = _prg_mask(dim, 7919 * round_idx + 13 * i + nxt)
                m_sub = _prg_mask(dim, 7919 * round_idx + 13 * prv + i)
                q = (q + m_add) % p
                q = (q + p - m_sub) % p
            partial = (partial + q) % p
        running = (running + partial) % p
        n_terms += len(members)
    return _dequantize_sum(running, n_terms, scale)


class TurboAggregateSimulator:
    """FedAvg whose aggregation runs through the group-ring protocol."""

    def __init__(self, args, fed_dataset, bundle, optimizer, spec,
                 device: torch.device,
                 init_params: Optional[Dict[str, Any]] = None):
        self.args = args
        self.fed = fed_dataset
        self.bundle = bundle
        self.opt = optimizer
        self.spec = spec
        self.device = torch.device(device)
        self.groups = int(getattr(args, "turbo_groups", 2) or 2)
        self.scale = float(getattr(args, "secagg_scale", 2 ** 16))
        seed = int(getattr(args, "random_seed", 0))
        # split(PRNGKey(seed)) = (init, local-training stream), as JAX
        self.rng = prng.split(prng.PRNGKey(seed))[1]
        if init_params is None:
            self.params = bundle.init(torch.Generator().manual_seed(seed),
                                      self.device)
        else:
            self.params = load_params(bundle, init_params, self.device)
        self.server_state = self.opt.server_init(self.params)
        self.batch_real = batch_real_of(fed_dataset.train.mask)
        self.train = fed_dataset.train.to(self.device)
        self.test = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device) for k, v in fed_dataset.test.items()}
        self.programs = StepPrograms(self.opt, self.params,
                                     self.server_state, self.train.client(0))
        self.history: List[Dict[str, Any]] = []

    def _ring_aggregate(self, updates: List[np.ndarray],
                        weights: List[float], round_idx: int) -> np.ndarray:
        return ring_aggregate(updates, weights, round_idx, self.groups,
                              self.scale)

    def run(self, comm_round: Optional[int] = None) -> Dict[str, Any]:
        rounds = int(comm_round if comm_round is not None
                     else self.args.comm_round)
        n_per_round = int(getattr(self.args, "client_num_per_round",
                                  self.fed.num_clients))
        hyper = TrainHyper(learning_rate=float(self.args.learning_rate),
                           epochs=int(self.args.epochs))
        cstate0 = self.opt.client_state_init(self.params)
        t0 = time.time()
        for r in range(rounds):
            rs = np.random.RandomState(300 + r)
            sampled = rs.choice(self.fed.num_clients,
                                min(n_per_round, self.fed.num_clients),
                                replace=False)
            updates, weights = [], []
            metrics_sum = {"loss_sum": 0.0, "correct": 0.0, "count": 0.0}
            for cid in sampled:
                key = prng.fold_in(prng.fold_in(self.rng, r), int(cid))
                out, _ = self.opt.local_train(
                    self.params, self.server_state, cstate0,
                    self.train.client(int(cid)), key, hyper,
                    batch_real=self.batch_real[int(cid)],
                    programs=self.programs)
                updates.append(tree_flatten_to_vector(out.update)
                               .cpu().numpy().astype(np.float64))
                weights.append(float(out.weight))
                for k in metrics_sum:
                    metrics_sum[k] += float(out.metrics[k])
            agg_vec = self._ring_aggregate(updates, weights, r)
            agg = vector_to_tree_like(
                torch.from_numpy(agg_vec.astype(np.float32)).to(self.device),
                self.params)
            self.params, self.server_state = self.opt.server_update(
                self.params, self.server_state, agg,
                self.opt.server_extras_zero(self.params), r)
            cnt = max(metrics_sum["count"], 1.0)
            rec: Dict[str, Any] = {
                "round": r, "train_loss": metrics_sum["loss_sum"] / cnt,
                "train_acc": metrics_sum["correct"] / cnt}
            freq = int(getattr(self.args, "frequency_of_the_test", 5) or 5)
            if r % freq == 0 or r == rounds - 1:
                stats = evaluate(self.spec, self.params, self.test["x"],
                                 self.test["y"], self.test["mask"])
                n = max(float(stats["count"]), 1.0)
                rec["test_acc"] = float(stats["correct"]) / n
                logger.info("turbo round %d: acc=%.4f", r, rec["test_acc"])
            self.history.append(rec)
        last = next((h for h in reversed(self.history) if "test_acc" in h),
                    {})
        return {"params": self.params, "history": self.history,
                "final_test_acc": last.get("test_acc"),
                "wall_time_s": time.time() - t0, "rounds": rounds}
