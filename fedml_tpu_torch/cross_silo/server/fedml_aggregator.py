"""Server-side aggregation state for the WAN FSM (counterpart of
``fedml_tpu/cross_silo/server/fedml_aggregator.py``).

``add_local_trained_result``, the all-received barrier with its round
timeout and quorum, ``aggregate`` with the defense / DP hooks, silo
selection and data-silo selection, as in the JAX package. The silos'
models are state dicts on the server's device; ``aggregate`` sums them
in sorted rank order through ``core/collectives.tree_weighted_average``
(the JAX aggregator's arithmetic).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...core.collectives import (tree_add, tree_map, tree_sub,
                                 tree_weighted_average)
from ...core.dp import FedMLDifferentialPrivacy
from ...core.security import FedMLDefender
from ...core.selection import ClientStatsStore
from ...simulation.sampling import (client_sampling,
                                    sampling_stream_from_args)

logger = logging.getLogger(__name__)


def clamped_wait(remaining: Optional[float], cap: float = 1.0,
                 floor: float = 0.05) -> float:
    """Bound a condition-variable wait derived from a deadline.

    The old inline expression ``min(remaining or 1.0, 1.0)`` was a trap:
    ``remaining == 0.0`` is falsy and became a full extra second past the
    deadline, and a negative underflow passed a negative timeout straight
    to ``Condition.wait``. Clamp to ``[floor, cap]`` — the floor also
    keeps a passed-deadline-below-quorum loop from busy-spinning."""
    if remaining is None:
        return cap
    return min(max(float(remaining), floor), cap)


class FedMLAggregator:
    def __init__(self, args, global_params, eval_fn=None):
        self.args = args
        self.global_params = global_params
        self.eval_fn = eval_fn
        self.client_num = int(getattr(args, "client_num_per_round", 1))
        self.defender = FedMLDefender(args)
        self.dp = FedMLDifferentialPrivacy(args)
        self.round_timeout_s = float(getattr(args, "round_timeout_s", 0) or 0)
        # fault tolerance: a timed-out round aggregates only when at least
        # ``quorum`` silos reported (ceil(round_quorum_frac * expected),
        # min 1) — averaging a one-silo sliver under heavy chaos is worse
        # than waiting another timeout interval
        frac = float(getattr(args, "round_quorum_frac", 0.0) or 0.0)
        self._quorum_frac = frac
        self._base_quorum = max(1, int(np.ceil(frac * self.client_num))) \
            if frac > 0 else 1
        self.quorum = self._base_quorum
        # silo selection (core/selection): per-RANK observed upload
        # latencies + quorum history (which silos missed their rounds),
        # consulted by select_silos when a non-uniform client_selection
        # strategy is configured. Passive (records only) otherwise.
        self.selection_strategy = str(getattr(args, "client_selection",
                                              "uniform") or "uniform").lower()
        self.silo_stats = ClientStatsStore(
            max(self.client_num + 1, 2),
            loss_window=int(getattr(args, "selection_loss_window", 8) or 8),
            ema_alpha=float(getattr(args, "selection_ema_alpha", 0.2)
                            or 0.2),
            # light prior: a silo server gets ONE availability observation
            # per (slow, minutes-long) round — benching must react within
            # a handful of missed rounds, not nineteen
            drop_prior=(1.0, 4.0))
        self._expected = self.client_num
        self._lock = threading.Condition()
        self._reset_round()

    def _reset_round(self) -> None:
        self.model_dict: Dict[int, Any] = {}
        self.sample_num_dict: Dict[int, float] = {}
        self.flag_client_model_uploaded_dict: Dict[int, bool] = {}
        self._round_start = time.time()
        # restore BOTH per-round values: a quorum scaled down by
        # set_round_expected must not leak into later rounds that bench
        # nobody (it would silently weaken the configured quorum floor)
        self._expected = self.client_num
        self.quorum = getattr(self, "_base_quorum", 1)

    # --- per-round expected cohort (silo selection seam) --------------------
    def set_round_expected(self, n: int) -> None:
        """Shrink THIS round's all-received barrier to the silos actually
        selected (select_silos). Quorum scales with it. Reset to the full
        cohort by the post-aggregation _reset_round."""
        with self._lock:
            self._expected = max(1, min(int(n), self.client_num))
            if self._quorum_frac > 0:
                self.quorum = max(1, int(np.ceil(self._quorum_frac
                                                 * self._expected)))
            self._lock.notify_all()

    # --- observed silo behavior (fed by the server FSM) ---------------------
    def observe_upload(self, rank: int, latency_s: float) -> None:
        """One silo upload's broadcast→receipt latency."""
        if 0 <= int(rank) < self.silo_stats.n:
            self.silo_stats.record_latency(int(rank), float(latency_s))

    def observe_round(self, reported, expected) -> None:
        """Round-close quorum history: which of the silos the round
        expected actually reported — the Beta-posterior dropout evidence
        silo selection runs on. ``expected`` must be the SELECTED cohort
        only: a benched silo losing the shrunken barrier's race is not
        dropout evidence (counting it would self-reinforce the bench
        forever). A benched silo that DOES report heals — that is the
        redemption path."""
        rep = set(int(r) for r in reported)
        exp = set(int(r) for r in expected)
        for r in exp:
            if 0 <= r < self.silo_stats.n:
                self.silo_stats.record_availability(r, participated=r in rep)
        for r in rep - exp:
            if 0 <= r < self.silo_stats.n:
                self.silo_stats.record_availability(r, participated=True)

    def select_silos(self, online_ranks) -> List[int]:
        """Which online silos to include in the next round. ``uniform``
        (default): all of them — byte-identical FSM. Non-uniform
        strategies bench silos whose posterior dropout probability is
        high (they would only burn the round timeout), never benching
        below max(quorum, min_keep_frac) of the online set."""
        ranks = sorted(int(r) for r in online_ranks)
        if self.selection_strategy == "uniform" or len(ranks) <= 1:
            return ranks
        from ...core.selection.strategies import cap_bench, rep_bench_knobs
        # two independent bench signals: the dropout POSTERIOR (silos
        # that will only burn the round timeout) and — where defended
        # async pours feed defense verdicts into silo_stats — the
        # REPUTATION posterior (silos the defenses keep excluding).
        # Reputation only bites where verdict evidence exists; undefended
        # sessions see rep == 1 everywhere and behave exactly as before.
        post = self.silo_stats.dropout_posterior_mean()
        rep = self.silo_stats.reputation
        rep_thresh, keep_frac = rep_bench_knobs(self.args)
        flaky = [r for r in ranks
                 if r < self.silo_stats.n
                 and (post[r] > 0.5 or rep[r] < rep_thresh)]
        benched = set(cap_bench(
            len(ranks), flaky,
            badness=lambda r: float(post[r]) + float(1.0 - rep[r]),
            keep_frac=keep_frac, quorum=self.quorum))
        return [r for r in ranks if r not in benched]

    def add_local_trained_result(self, index: int, model_params,
                                 sample_num: float) -> None:
        with self._lock:
            self.model_dict[index] = model_params
            self.sample_num_dict[index] = float(sample_num)
            self.flag_client_model_uploaded_dict[index] = True
            self._lock.notify_all()

    def add_local_trained_delta(self, index: int, delta_vec,
                                sample_num: float,
                                base_vec=None) -> None:
        """Wire-efficient upload path: reconstruct the sender's full model
        from a decompressed update delta (host f32 vector, flattened in
        the global tree's leaf order), then store it like any dense
        upload — weighted aggregation, defenses, and DP all run
        downstream in float32, unchanged.

        ``base_vec`` is the model vector the SENDER trained from. It must
        be supplied when the broadcast itself was compressed: the clients
        hold a reconstruction that differs from the server's exact global,
        and adding their deltas to the wrong base re-injects that gap into
        the average every round (a systematic bias that diverges). When
        the broadcast was dense, the current global IS the base."""
        from ..wire import vec_to_params
        if base_vec is not None:
            vec = (np.asarray(base_vec, np.float32)
                   + np.asarray(delta_vec, np.float32))
            params = vec_to_params(vec, self.global_params)
        else:
            delta = vec_to_params(np.asarray(delta_vec, np.float32),
                                  self.global_params)
            params = tree_add(self.global_params, delta)
        self.add_local_trained_result(index, params, sample_num)

    def check_whether_all_receive(self) -> bool:
        with self._lock:
            return len(self.model_dict) >= self._expected

    def wait_all_or_timeout(self) -> bool:
        """Block until every expected silo reported, or the round timeout
        elapsed with at least ``quorum`` reports. Returns True if
        aggregation can proceed; False when the (doubled, as a hard cap)
        deadline passes below quorum. Waits are clamped
        (:func:`clamped_wait`) so deadline underflow can neither overshoot
        the deadline by a spurious second nor busy-spin / pass a negative
        timeout to ``Condition.wait``."""
        with self._lock:
            while True:
                n = len(self.model_dict)
                if n >= self._expected:
                    return True
                remaining = None
                if self.round_timeout_s > 0:
                    elapsed = time.time() - self._round_start
                    remaining = self.round_timeout_s - elapsed
                    if remaining <= 0:
                        if n >= self.quorum:
                            return True
                        # below quorum: grant a grace interval (one more
                        # timeout) before giving up on the round
                        if elapsed >= 2.0 * self.round_timeout_s:
                            return False
                self._lock.wait(timeout=clamped_wait(remaining))

    def aggregate(self, round_key=None):
        """Weighted average of received silo models (hook chain: defense ->
        aggregate -> DP noise, reference ``server_aggregator.py:44-103``)."""
        with self._lock:
            idxs = sorted(self.model_dict)
            models = [self.model_dict[i] for i in idxs]
            dev = next(iter(self.global_params.values())).device
            weights = torch.tensor([self.sample_num_dict[i] for i in idxs],
                                   dtype=torch.float32, device=dev)
        stacked = tree_map(lambda *xs: torch.stack(xs), *models)
        if self.defender.is_defense_enabled():
            # defenses act on deltas from the current global model
            deltas = tree_map(lambda s, g: s - g[None], stacked,
                              self.global_params)
            agg_delta, _ = self.defender.defend(deltas, weights, round_key,
                                                np.asarray(idxs))
            new_global = tree_add(self.global_params, agg_delta)
        else:
            new_global = tree_weighted_average(stacked, weights)
        if self.dp.is_global_dp_enabled() and round_key is not None:
            delta = tree_sub(new_global, self.global_params)
            delta = self.dp.add_global_noise(delta, round_key)
            new_global = tree_add(self.global_params, delta)
        self.global_params = new_global
        self._reset_round()
        return new_global

    def test_on_server(self) -> Optional[Dict[str, float]]:
        if self.eval_fn is None:
            return None
        return self.eval_fn(self.global_params)

    # --- selection (reference :113,:139) ------------------------------------
    # Both draws ride simulation.sampling.client_sampling: the legacy
    # stream (default) reproduces the reference's np.random.seed(round_idx)
    # sequence bit-for-bit WITHOUT clobbering the process-global RNG, and
    # sampling_stream: seeded folds random_seed in.
    def client_selection(self, round_idx: int, client_num_in_total: int,
                         client_num_per_round: int) -> List[int]:
        return [int(c) for c in client_sampling(
            round_idx, client_num_in_total, client_num_per_round,
            random_seed=int(getattr(self.args, "random_seed", 0) or 0),
            stream=sampling_stream_from_args(self.args))]

    def data_silo_selection(self, round_idx: int, data_silo_num: int,
                            client_num_in_total: int) -> List[int]:
        if data_silo_num <= client_num_in_total:
            return list(range(client_num_in_total))
        return [int(c) for c in client_sampling(
            round_idx, data_silo_num, client_num_in_total,
            random_seed=int(getattr(self.args, "random_seed", 0) or 0),
            stream=sampling_stream_from_args(self.args))]

    def assign_data_indices(self, ranks, client_indexes) -> Dict[int, int]:
        """rank -> DATA index for this round's broadcast.

        ``silo_index_assignment: legacy`` (default) is the reference's
        round-robin — the i-th rank in iteration order gets
        ``client_indexes[i % len]``, bit-identical to before. With
        ``scored``, ranks are scored by the stats store
        (availability posterior over observed latency — the silo most
        likely to actually deliver, fastest), and the FIRST-sampled data
        indices go to the best-scoring silos: the partitions the sampler
        put at the head of the round's list are the ones most likely to
        make it into the aggregate, and soonest. Ties (and unobserved
        silos, which score neutral) keep rank order, so a cold store
        degrades to legacy exactly."""
        mode = str(getattr(self.args, "silo_index_assignment", "legacy")
                   or "legacy").lower()
        ranks = [int(r) for r in ranks]
        idx = list(client_indexes)
        if mode == "legacy" or len(ranks) <= 1:
            return {r: int(idx[i % len(idx)]) for i, r in enumerate(ranks)}
        if mode != "scored":
            raise ValueError(
                f"silo_index_assignment {mode!r} unknown; choose from "
                "('legacy', 'scored')")
        st = self.silo_stats
        post = st.dropout_posterior_mean()
        lat = np.where(st.has_latency > 0, st.ema_latency, np.nan)
        obs = lat[np.isfinite(lat)]
        fill = float(np.median(obs)) if obs.size else 1.0
        score = []
        for r in ranks:
            if 0 <= r < st.n:
                avail = 1.0 - float(post[r])
                speed = fill if not np.isfinite(lat[r]) else float(lat[r])
            else:
                avail, speed = 1.0 - float(np.mean(post)), fill
            score.append(avail / max(speed, 1e-9))
        order = np.argsort(-np.asarray(score), kind="stable")
        return {ranks[int(r)]: int(idx[i % len(idx)])
                for i, r in enumerate(order)}
