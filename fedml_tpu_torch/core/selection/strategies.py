"""Pluggable participant-selection strategies (``client_selection`` knob).

Selection stays HOST-side by design: a strategy turns the
:class:`~fedml_tpu_torch.core.selection.stats.ClientStatsStore`'s observed
history into the next round's cohort, and the cohort rides the jitted
round programs purely as schedule DATA (indices / active mask / work
fractions) — the compiled programs never change shape, so the canonical
slot width and the compile-once invariant hold for every strategy.

Strategies:

* ``uniform`` — the reference's per-round draw, bit-identical to the
  pre-selection schedules at default knobs (it delegates to
  :func:`~fedml_tpu_torch.simulation.sampling.client_sampling` on the same
  stream).
* ``power_of_choice`` (Cho et al., 2020) — sample ``d = d_factor * k``
  candidates uniformly, keep the ``k`` with the highest last observed
  loss. Unobserved clients rank as +inf loss, so exploration is built in.
* ``oort`` (Lai et al., OSDI 2021, simplified) — utility = statistical
  utility (RMS of the recent loss window + a temporal-uncertainty bonus
  for stale clients) × a system penalty for clients slower than the
  preferred latency; an ε fraction of each cohort explores never-selected
  clients.
* ``reputation`` — the byzantine-aware-dropout closer: sample on the
  UNIFORM stream (schedules stay comparable), then bench sampled clients
  whose defense-verdict reputation fell below the threshold. The engine
  turns benched clients into in-program dropout (work fraction 0,
  renormalized over survivors under ``chaos_tolerance``) instead of
  letting the defense zero their rows round after round — they stop
  burning training compute, and the denominator no longer carries them.

**Population scaling** (the million-client control plane): strategies
score a seeded *candidate pool* of ``m ≫ k`` ids instead of the full
population once ``n`` crosses ``selection_pool_threshold`` (or always,
with an explicit ``selection_candidate_pool``), and take the cohort via
``np.argpartition`` partial top-k — O(m + k log k) per round instead of
O(N log N), with store reads going through the id-parameterized query
surface so a sparse stats backend never materializes ``[N]`` state.
Below the threshold the legacy full-population path runs UNCHANGED
(bit-identical selections — the dense-parity pin).

Every stochastic draw is a pure function of ``(random_seed, strategy tag,
round_idx)`` via a fresh ``np.random.default_rng`` — rerunning a round
with the same observed history replays the same cohort, which is what
makes crash-resume selections assertable.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ...simulation.sampling import (FAST_SAMPLE_MIN_N, client_sampling,
                                    sample_ids_streaming,
                                    sampling_stream_from_args)
from .stats import ClientStatsStore

logger = logging.getLogger(__name__)

# domain-separation tags for the per-strategy PRNG streams
_TAG_POC = 101
_TAG_OORT = 103
_TAG_POOL = 107

SELECTION_STRATEGIES = ("uniform", "power_of_choice", "oort", "reputation")

# population size past which candidate pools engage by default
# (selection_pool_threshold knob); matches the schedule-sampling fast
# path so "small N" means the same thing across the selection plane
DEFAULT_POOL_THRESHOLD = FAST_SAMPLE_MIN_N

Selection = Tuple[List[int], List[int]]  # (sampled ids, benched subset)


def pool_size(args, n: int, k: int) -> Optional[int]:
    """Candidate-pool size ``m`` for a population of ``n`` and cohort of
    ``k`` — or None for the legacy full-population path.

    ``selection_candidate_pool`` > 0 forces a pool of that size at any
    ``n`` (clamped to [k, n]); 0/unset means AUTO: full population below
    ``selection_pool_threshold`` (small-N selections stay bit-identical),
    ``m = ceil(selection_pool_factor * k)`` above it."""
    explicit = int(getattr(args, "selection_candidate_pool", 0) or 0)
    if explicit > 0:
        return int(min(max(explicit, k), n))
    threshold = int(getattr(args, "selection_pool_threshold",
                            DEFAULT_POOL_THRESHOLD)
                    or DEFAULT_POOL_THRESHOLD)
    if n < threshold:
        return None
    factor = float(getattr(args, "selection_pool_factor", 16.0) or 16.0)
    m = int(np.ceil(max(factor, 1.0) * max(k, 1)))
    return int(min(max(m, k), n))


def partial_top_k(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the ``k`` highest scores, highest first — O(m) select
    + O(k log k) order via ``np.argpartition`` instead of a full sort.
    Ties break by LOWEST index (deterministic), matching a stable
    descending argsort."""
    k = min(int(k), len(scores))
    if k <= 0:
        return np.empty(0, np.int64)
    if k >= len(scores):
        return np.argsort(-scores, kind="stable")
    kth = scores[np.argpartition(-scores, k - 1)[k - 1]]
    # ties straddling the k boundary: argpartition picks an arbitrary
    # subset of the kth-value ties — take the lowest-index ones instead,
    # exactly what a stable descending argsort would keep
    above = np.flatnonzero(scores > kth)
    ties = np.sort(np.flatnonzero(scores == kth))
    top = np.concatenate([above, ties[:k - len(above)]])
    return top[np.lexsort((top, -scores[top]))]


def rep_bench_knobs(args) -> Tuple[float, float]:
    """(reputation threshold, min-keep fraction) — the ONE reading shared
    by the simulator's reputation strategy, the cross-silo silo
    selection, and the async engine's rotation benching; three
    independent ``getattr`` chains would let the default (or the
    None-falls-back-to-0 handling) drift per surface."""
    return (float(getattr(args, "selection_rep_threshold", 0.3) or 0.0),
            float(getattr(args, "selection_min_keep_frac", 0.5) or 0.5))


def cap_bench(cohort_n: int, flagged, badness, keep_frac: float,
              quorum: int = 1) -> List[int]:
    """The ONE bench-floor policy, shared by the simulator's reputation
    strategy and the cross-silo server's silo selection: never bench below
    ``max(quorum, ceil(keep_frac * cohort))`` survivors, and when the
    flagged set exceeds the cap keep only the WORST offenders (highest
    ``badness``). An adversary that poisons scores must not be able to
    empty a cohort, and a policy fix here fixes both callers."""
    min_keep = max(int(quorum), int(np.ceil(keep_frac * cohort_n)), 1)
    max_bench = max(cohort_n - min_keep, 0)
    flagged = list(flagged)
    if len(flagged) > max_bench:
        flagged = sorted(flagged, key=badness, reverse=True)[:max_bench]
    return flagged


class SelectionStrategy:
    """``select(round_idx, n) -> (sampled, excluded)``: ``sampled`` is the
    scheduled cohort in placement order; ``excluded`` ⊆ ``sampled`` are
    clients the strategy benches — the engine schedules them with work
    fraction 0 (renormalized in-program dropout), it does not unschedule
    them, so schedule shapes stay strategy-independent."""

    name = "?"

    def __init__(self, args, num_clients: int, store: ClientStatsStore):
        self.args = args
        self.n = int(num_clients)
        self.store = store
        self.seed = int(getattr(args, "random_seed", 0) or 0)
        self.stream = sampling_stream_from_args(args)

    def _uniform(self, round_idx: int, n: int) -> List[int]:
        return [int(c) for c in client_sampling(
            round_idx, self.n, n, random_seed=self.seed,
            stream=self.stream)]

    def _rng(self, tag: int, round_idx: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, tag, int(round_idx)))

    def _pool(self, round_idx: int, k: int) -> Optional[np.ndarray]:
        """Seeded candidate pool of m ids, or None for the legacy
        full-population path. The pool rides its OWN tag (and generator)
        so enabling it never perturbs a strategy's other draws."""
        m = pool_size(self.args, self.n, k)
        if m is None or m >= self.n:
            return None
        return sample_ids_streaming(self._rng(_TAG_POOL, round_idx),
                                    self.n, m)

    def select(self, round_idx: int, n: int) -> Selection:
        raise NotImplementedError


class UniformSelection(SelectionStrategy):
    name = "uniform"

    def select(self, round_idx: int, n: int) -> Selection:
        return self._uniform(round_idx, n), []


class PowerOfChoiceSelection(SelectionStrategy):
    name = "power_of_choice"

    def select(self, round_idx: int, n: int) -> Selection:
        n = min(int(n), self.n)
        d_factor = float(getattr(self.args, "poc_d_factor", 2.0) or 2.0)
        d = int(min(self.n, max(n, int(np.ceil(n * max(d_factor, 1.0))))))
        rng = self._rng(_TAG_POC, round_idx)
        # d is already poc's candidate pool; the SAME knobs that govern
        # the other strategies' pools decide when the draw leaves the
        # legacy path (explicit selection_candidate_pool forces it,
        # selection_pool_threshold gates the auto switch) — only the
        # DRAW changes (O(d) streaming ids, no [N] permutation)
        if pool_size(self.args, self.n, n) is not None:
            cands = sample_ids_streaming(rng, self.n, d)
            score = self.store.last_loss_for(cands)
            return [int(c) for c in cands[partial_top_k(score, n)]], []
        cands = rng.choice(self.n, d, replace=False)
        # highest-loss first; the candidate draw is already a random
        # permutation, so equal scores tie-break randomly but stably
        score = self.store.last_loss_for(cands)
        order = np.argsort(-score, kind="stable")
        return [int(c) for c in cands[order[:n]]], []


class OortSelection(SelectionStrategy):
    name = "oort"

    def _utility_for(self, round_idx: int,
                     ids: np.ndarray) -> np.ndarray:
        """Oort utility for the given candidate ids — all store reads go
        through the id-parameterized surface, so cost is O(len(ids)) on
        both stats backends."""
        st = self.store
        stat = st.rms_loss_for(ids)
        seen = np.isfinite(stat)
        # never-observed clients get the observed mean utility (neutral):
        # the explore slots are their on-ramp, not a fake-high score
        fill = st.observed_rms_mean()
        if not np.isfinite(fill):
            fill = 1.0
        stat = np.where(seen, stat, fill)
        # temporal uncertainty (Oort eq. 2): clients not picked recently
        # regain priority instead of starving on a stale low loss
        age = np.maximum(int(round_idx) - st.last_selected_for(ids), 1)
        stat = stat + np.sqrt(0.1 * np.log(max(round_idx, 1) + 1.0) / age)
        # system utility: penalize clients slower than the preferred
        # latency (knob; 0 = the observed median), Oort's (T/t)^alpha
        alpha = float(getattr(self.args, "oort_alpha", 2.0) or 0.0)
        lat = st.latency_for(ids)
        pref = float(getattr(self.args, "oort_pref_latency_s", 0.0) or 0.0)
        if pref <= 0.0:
            pref = st.observed_latency_median()
            if not np.isfinite(pref):
                pref = 0.0
        if pref > 0.0 and alpha > 0.0:
            with np.errstate(invalid="ignore", divide="ignore"):
                pen = np.power(pref / np.maximum(lat, 1e-9), alpha)
            sys_u = np.where(np.isnan(lat) | (lat <= pref), 1.0,
                             np.minimum(pen, 1.0))
        else:
            sys_u = np.ones(len(ids), np.float32)
        # the simulator has no wall-clock per client, but it observes work
        # fractions: chronic stragglers (low EMA work) are the same signal
        return stat * sys_u * np.clip(st.ema_work_for(ids), 0.05, 1.0)

    def _utility(self, round_idx: int) -> np.ndarray:
        """[n] whole-population utility — the async engine's
        dispatch-ranking read (its rotation covers every client, so the
        materialization is the point there, not an accident)."""
        return self._utility_for(round_idx, np.arange(self.n))

    def select(self, round_idx: int, n: int) -> Selection:
        n = min(int(n), self.n)
        pool = self._pool(round_idx, n)
        cands = pool if pool is not None else np.arange(self.n)
        rng = self._rng(_TAG_OORT, round_idx)
        explore_frac = float(getattr(self.args, "oort_explore_frac", 0.1)
                             or 0.0)
        # positions (into cands) of never-selected candidates
        unexplored = np.flatnonzero(
            self.store.times_selected_for(cands) == 0)
        n_explore = min(int(np.ceil(n * max(explore_frac, 0.0))),
                        len(unexplored), n)
        explore = (rng.choice(unexplored, n_explore, replace=False)
                   if n_explore else np.empty(0, np.int64))
        util = self._utility_for(round_idx, cands)
        util[explore] = -np.inf  # already taken by the explore slots
        if pool is None:
            order = np.argsort(-util, kind="stable")
            exploit = order[:n - n_explore]
        else:
            exploit = partial_top_k(util, n - n_explore)
        picked = np.concatenate([exploit, explore])
        return [int(c) for c in cands[picked]], []


class ReputationSelection(SelectionStrategy):
    name = "reputation"

    def select(self, round_idx: int, n: int) -> Selection:
        sampled = self._uniform(round_idx, n)
        thresh, keep_frac = rep_bench_knobs(self.args)
        rep = self.store.reputation_for(sampled)
        by_id = {int(c): float(r) for c, r in zip(sampled, rep)}
        benched = cap_bench(
            len(sampled), [c for c in sampled if by_id[c] < thresh],
            badness=lambda c: -by_id[c], keep_frac=keep_frac)
        return sampled, benched


_STRATEGIES = {cls.name: cls for cls in
               (UniformSelection, PowerOfChoiceSelection, OortSelection,
                ReputationSelection)}


def create_strategy(args, num_clients: int,
                    store: ClientStatsStore) -> SelectionStrategy:
    name = str(getattr(args, "client_selection", "uniform")
               or "uniform").lower()
    cls = _STRATEGIES.get(name)
    if cls is None:
        raise ValueError(
            f"client_selection {name!r} unknown; choose from "
            f"{tuple(sorted(_STRATEGIES))}")
    return cls(args, num_clients, store)
