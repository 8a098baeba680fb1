"""Single-process golden simulator (counterpart of
``fedml_tpu/simulation/sp/simulator.py``, ``SPSimulator``).

The round as a plain Python loop over the sampled clients, each client
trained by the eager loop (``run_local_sgd``: no captured step) from the
global params and its own entry of ``client_states`` (a list, one entry
per client, replaced by the state the client returns), the updates and
extras averaged with ``n_k / Σ n_k`` weights by the GPU engine's
arithmetic (:class:`~fedml_tpu_torch.core.collectives.WeightedSum`) and
applied by the optimizer's server step. It is the semantic reference the GPU engine
is held to, and the eager baseline of the flagship benchmark's
``vs_baseline``.

DP, attacks and defenses run as in the JAX golden loop: each client's
update is clipped and noised (LDP, NbAFL) or clipped (CDP) as it comes
back, a data attack poisons the clients' host arrays at construction, and
with a model attack, a defense or contribution assessment the round's
updates become the ``[K, D]`` matrix of the JAX package's flat layout,
which the host kernels (``FedMLAttacker.poison_updates``,
``FedMLDefender.defend_matrix``) attack and defend (``_aggregate_robust``);
contribution (LOO, GTG-Shapley) is assessed on the post-attack matrix
before the defense; CDP noises the aggregate.

Participant selection runs as in the JAX loop: the strategy draws each
round's cohort (uniform at the defaults: the sampling stream's draw), a
reputation-benched client is not trained, each trained client's loss goes
straight to the stats store and each defense verdict to its reputation.
``pacer_adapt_cohort`` sizes the cohort with the ``DeadlinePacer`` from
the summed per-client loss. The SP loop injects no chaos (as in JAX; the
runner refuses its knobs here). Round checkpoints
(``checkpoint_dir`` / ``checkpoint_every_rounds``) hold what the GPU
engine's hold, and the pacer's state; the host kernels' cross-round state
is not in them, as in JAX.
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
from ...core.checkpoint import RoundCheckpointer
from ...core.collectives import FlatLayout, WeightedSum
from ...core.contribution import ContributionAssessorManager
from ...core.dp import FedMLDifferentialPrivacy
from ...core.obs import sink as obs_sink
from ...core.security import FedMLAttacker, FedMLDefender
from ...core.selection import DeadlinePacer, SelectionManager
from ..gpu.engine import (GPUSimulator, assess_contribution,
                          check_extras_compat, dp_client_update,
                          dp_server_noise, host_robust_aggregate,
                          load_params)

logger = logging.getLogger(__name__)


class SPSimulator:
    """Python round loop over eager per-client local training on
    ``device``."""

    def __init__(self, args, fed_dataset, bundle, optimizer, spec,
                 device: torch.device,
                 init_params: Optional[Dict[str, Any]] = None):
        self.args = args
        self.fed = fed_dataset
        self.bundle = bundle
        self.opt = optimizer
        self.spec = spec
        self.device = device
        seed = int(getattr(args, "random_seed", 0))
        # split(PRNGKey(seed)) = (init, round stream), as the JAX loop
        self.rng = prng.split(prng.PRNGKey(seed))[1]
        self.attacker = FedMLAttacker(args)
        self.defender = FedMLDefender(args)
        self.dp = FedMLDifferentialPrivacy(args)
        if self.attacker.is_data_attack():
            from ..poisoning import poison_dataset
            fed_dataset = poison_dataset(fed_dataset, self.attacker)
            self.fed = fed_dataset
        self.batch_real = batch_real_of(fed_dataset.train.mask)
        self.train = fed_dataset.train.to(device)
        self.test = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in fed_dataset.test.items()}
        if init_params is None:
            self.params = bundle.init(torch.Generator().manual_seed(seed),
                                      device)
        else:
            self.params = load_params(bundle, init_params, device)
        self.server_state = optimizer.server_init(self.params)
        self.client_states = [optimizer.client_state_init(self.params)
                              for _ in range(fed_dataset.num_clients)]
        defended = (self.attacker.is_model_attack()
                    or self.defender.is_defense_enabled())
        check_extras_compat(optimizer, self.params, self.dp, defended)
        self.contribution = ContributionAssessorManager(args)
        self.robust_mode = defended or self.contribution.enabled
        # participant selection (the engine's subsystem, same knobs):
        # passive at the defaults
        self.selection = SelectionManager(args, fed_dataset.num_clients)
        # pacer-driven cohort sizing (off = client_num_per_round)
        self.pacer = (DeadlinePacer.from_args(args)
                      if bool(getattr(args, "pacer_adapt_cohort", False))
                      else None)
        self.layout = FlatLayout.of(self.params)
        self.verdicts = {}
        self.history: List[Dict[str, Any]] = []
        self.ckpt = RoundCheckpointer(
            getattr(args, "checkpoint_dir", None),
            int(getattr(args, "checkpoint_every_rounds", 0) or 0))

    # the GPU engine's checkpoint state and its restore, plus the pacer's
    _OPTIONAL_CKPT_KEYS = GPUSimulator._OPTIONAL_CKPT_KEYS + ("pacer",)
    restore = GPUSimulator.restore
    _ckpt_latest = GPUSimulator._ckpt_latest

    def ckpt_state(self) -> Dict[str, Any]:
        st = GPUSimulator.ckpt_state(self)
        if self.pacer is not None:
            st["pacer"] = self.pacer.state_dict()
        return st

    def _load_ckpt_state(self, st: Dict[str, Any]) -> None:
        GPUSimulator._load_ckpt_state(self, st)
        if "pacer" in st:
            self.pacer.load_state_dict(st["pacer"])

    def _evaluate(self) -> Dict[str, float]:
        stats = evaluate(self.spec, self.params, self.test["x"],
                         self.test["y"], self.test["mask"])
        n = max(float(stats["count"]), 1.0)
        return {"test_acc": float(stats["correct"]) / n,
                "test_loss": float(stats["loss_sum"]) / n}

    def run(self, comm_round: Optional[int] = None) -> Dict[str, Any]:
        args = self.args
        rounds = comm_round if comm_round is not None else int(
            args.comm_round)
        hyper = TrainHyper(learning_rate=float(args.learning_rate),
                           epochs=int(args.epochs))
        freq = int(getattr(args, "frequency_of_the_test", 5) or 5)
        t0 = time.time()
        for round_idx in range(self.restore(), rounds):
            # a reputation strategy's benched clients are not trained here:
            # the SP loop has no work-0 slot to renormalize
            k_round = int(args.client_num_per_round)
            if self.pacer is not None:
                k_round = min(self.pacer.paced_cohort(k_round),
                              self.fed.num_clients)
            full_sampled, excluded = self.selection.select(round_idx,
                                                           k_round)
            excl = set(int(c) for c in excluded)
            sampled = [int(c) for c in full_sampled if int(c) not in excl]
            self.selection.note_schedule(
                round_idx, full_sampled, excluded,
                {c: 1.0 for c in sampled}, target_n=len(full_sampled))
            round_key = prng.fold_in(self.rng, round_idx)
            acc = WeightedSum(self.params,
                              self.opt.server_extras_zero(self.params))
            metrics, updates, weights = [], [], []
            for cid in sampled:
                ckey = prng.fold_in(round_key, cid)
                out, _ = self.opt.local_train(
                    self.params, self.server_state, self.client_states[cid],
                    self.train.client(cid), ckey, hyper,
                    batch_real=self.batch_real[cid])
                out = out.replace(update=dp_client_update(
                    self.dp, out.update, ckey))
                acc.add(out)
                if self.robust_mode:
                    updates.append(self.layout.flatten(out.update))
                    weights.append(out.weight)
                metrics.append(out.metrics)
                if self.opt.has_client_state:
                    self.client_states[cid] = out.client_state
            if self.selection.track or self.pacer is not None:
                # per-client mean losses: the stats store's loss ring, and
                # their sum the round's utility for the pacer
                mean_loss = [float(m["loss_sum"]) / max(float(m["count"]),
                                                        1.0)
                             for m in metrics]
                if self.selection.track:
                    for cid, m, ml in zip(sampled, metrics, mean_loss):
                        if float(m["count"]) > 0:
                            self.selection.store.record_loss(cid, ml)
                if self.pacer is not None:
                    self.pacer.observe_utility(sum(mean_loss))
            agg, agg_extras = acc.mean()
            if self.robust_mode:
                agg = self._aggregate_robust(torch.stack(updates),
                                             torch.stack(weights), sampled,
                                             round_key, round_idx)
            agg = dp_server_noise(self.dp, agg, round_key)
            self.dp.record_round(len(sampled)
                                 / max(self.fed.num_clients, 1))
            self.params, self.server_state = self.opt.server_update(
                self.params, self.server_state, agg, agg_extras, round_idx)
            rec: Dict[str, Any] = {"round": round_idx}
            tm = {k: sum(m[k] for m in metrics) for k in metrics[0]}
            cnt = max(float(tm["count"]), 1.0)
            rec["train_loss"] = float(tm["loss_sum"]) / cnt
            rec["train_acc"] = float(tm["correct"]) / cnt
            # freq <= 0: never evaluate in the loop (timing mode)
            if freq > 0 and (round_idx % freq == 0
                             or round_idx == rounds - 1):
                rec.update(self._evaluate())
                logger.info("round %d: test_acc=%.4f test_loss=%.4f",
                            round_idx, rec["test_acc"], rec["test_loss"])
            self.history.append(rec)
            obs_sink.log_round_info(rounds, round_idx)
            self.ckpt.maybe_save(round_idx, self.ckpt_state())
        # the writes must be on disk before the run returns
        self.ckpt.flush()
        wall = time.time() - t0
        last_eval = next((r for r in reversed(self.history)
                          if "test_acc" in r), None)
        if last_eval is None:
            # timing mode: no eval, in the loop or here
            last_eval = ({"test_acc": None} if freq <= 0
                         else self._evaluate())
        result = {"params": self.params, "history": self.history,
                  "wall_time_s": wall,
                  "final_test_acc": last_eval["test_acc"],
                  "final_test_loss": last_eval.get("test_loss"),
                  "rounds": rounds}
        if self.dp.is_dp_enabled():
            result["dp_epsilon_spent"] = self.dp.get_epsilon_spent()
        return result

    def _aggregate_robust(self, mat: torch.Tensor, w: torch.Tensor, sampled,
                          round_key, round_idx: int):
        """The attack -> contribution -> defense pipeline on the round's
        ``[K, D]`` matrix through the host kernels (the JAX loop's
        ``_aggregate_robust``); returns the aggregate update. The verdict
        feeds the selection store's reputation."""
        assess = None
        if self.contribution.enabled:
            assess = lambda m: assess_contribution(  # noqa: E731
                self.contribution, self.spec, self.layout, self.params,
                self.test, m, w, sampled, round_idx)
        vec, verdict = host_robust_aggregate(self.attacker, self.defender,
                                             mat, w, sampled, round_key,
                                             assess=assess)
        if verdict is not None:
            self.verdicts[round_idx] = (list(sampled), verdict)
            if self.selection.track:
                self.selection.store.record_verdict(sampled,
                                                    np.asarray(verdict))
        return self.layout.unflatten(vec)
