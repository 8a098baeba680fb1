"""Streaming cohort assembly — the cross-device round's front door.

Bonawitz et al. (MLSys'19, "Towards Federated Learning at Scale")
structure a cross-device round as *selection* over the devices that
happen to be reachable AND eligible (charging, idle, on unmetered
network), sized by a pace-steering target; Lai et al. (OSDI'21, Oort)
add utility-guided picking with a deadline-driven **pacer** that trades
cohort over-sampling against the round deadline from observed
completions. This module is those three pieces for this repo's
cross-device plane, shaped so no step ever materializes the population:

* :func:`required_eligibility` / :func:`eligible_mask` — predicate over
  the charging/idle/unmetered analogues each device reports on its
  registration handshake (``DeviceMessage``);
* :class:`StreamingCohortAssembler` — scans candidate ids in chunks
  (an iterator of id arrays — the online-device table, or
  :func:`population_chunks` for synthetic sweeps), filters eligibility,
  scores via the stats store's id-parameterized queries (Oort utility,
  or uniform), and folds each chunk into a running partial top-k — O(m
  scanned + target·log target) time, O(chunk + target) memory;
* :class:`DeadlinePacer` — adjusts the round deadline and the cohort
  over-sample factor from observed (completed, expected, wall) outcomes:
  under-delivering rounds stretch the deadline and over-sample harder,
  comfortably-early rounds tighten both. With ``pacer_adapt_cohort`` it
  also moves the cohort size k itself (Oort §5's pacer rule): when the
  aggregate statistical utility of consecutive windows saturates, grow
  k to harvest more parallelism per round; while utility is still
  climbing, decay back toward the configured k. A pure function of the
  observation history (no RNG), so trajectories are replayable.

Scoring adds a tiny seeded per-id jitter — a hash of ``(seed, round,
id)``, independent of chunking — so the cold-start case (every candidate
at the neutral fill utility) selects a uniformly-spread cohort instead
of the lowest ids.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..obs import metrics as obs_metrics
from .strategies import OortSelection, partial_top_k

# the charging / idle / unmetered-network analogues a device reports on
# its handshake; every key defaults to True when unreported (a silent
# device is assumed eligible, matching the reference's behavior of
# training every registered phone)
ELIGIBILITY_KEYS = ("charging", "idle", "unmetered")

_JITTER_MULT = np.uint64(0x9E3779B97F4A7C15)  # splitmix64 increment


def required_eligibility(args) -> Tuple[str, ...]:
    """Which handshake predicates this deployment enforces
    (``cohort_require_charging`` / ``_idle`` / ``_unmetered`` knobs; all
    off by default — eligibility then never filters)."""
    return tuple(k for k in ELIGIBILITY_KEYS
                 if bool(getattr(args, f"cohort_require_{k}", False)))


def eligible_mask(metas: Iterable[dict],
                  required: Tuple[str, ...]) -> np.ndarray:
    """[len(metas)] bool — device metadata dicts vs the required keys."""
    metas = list(metas)
    if not required:
        return np.ones(len(metas), bool)
    return np.asarray([all(bool(m.get(k, True)) for k in required)
                       for m in metas], bool)


def population_chunks(n: int, chunk: int = 8192,
                      start: int = 0) -> Iterator[np.ndarray]:
    """Id ranges [start, n) as arrays of ≤ chunk ids — the synthetic
    full-population candidate source; only one chunk exists at a time."""
    chunk = max(int(chunk), 1)
    for lo in range(int(start), int(n), chunk):
        yield np.arange(lo, min(lo + chunk, int(n)), dtype=np.int64)


def _seeded_jitter(ids: np.ndarray, seed: int,
                   round_idx: int) -> np.ndarray:
    """[len(ids)] uniform-ish floats in [0, 1) from a splitmix64-style
    hash of (seed, round, id) — deterministic AND independent of how the
    candidate stream is chunked, unlike drawing from a sequential
    generator."""
    x = (ids.astype(np.uint64)
         + np.uint64((seed * 1_000_003 + round_idx * 7919) & 0xFFFFFFFF))
    x = (x + np.uint64(1)) * _JITTER_MULT
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return (x >> np.uint64(11)).astype(np.float64) / float(1 << 53)


@dataclass
class AssemblyResult:
    cohort: List[int]            # best-first
    scanned: int = 0             # candidate ids seen
    eligible: int = 0            # candidates passing the predicates
    wall_ms: float = 0.0
    scores: Optional[np.ndarray] = None  # per-cohort-member, best-first


class StreamingCohortAssembler:
    """Chunked eligibility scan + utility scoring + running partial
    top-k over any candidate-id stream."""

    def __init__(self, args, store, num_clients: int):
        self.args = args
        self.store = store
        self.n = int(num_clients)
        self.seed = int(getattr(args, "random_seed", 0) or 0)
        self.chunk = max(int(getattr(args, "cohort_scan_chunk", 8192)
                             or 8192), 1)
        scoring = str(getattr(args, "cohort_scoring", "oort")
                      or "oort").lower()
        if scoring not in ("oort", "uniform"):
            raise ValueError(f"cohort_scoring {scoring!r} unknown; choose "
                             "from ('oort', 'uniform')")
        self.scoring = scoring
        # utility math is shared with the engine's oort strategy — one
        # implementation, two planes
        self._oort = OortSelection(args, self.n, store)
        self.jitter = float(getattr(args, "cohort_jitter", 1e-6) or 0.0)

    def _score(self, round_idx: int, ids: np.ndarray) -> np.ndarray:
        if self.scoring == "uniform":
            base = np.zeros(len(ids), np.float64)
        else:
            base = np.asarray(
                self._oort._utility_for(round_idx, ids), np.float64)
        if self.jitter > 0.0:
            base = base + self.jitter * _seeded_jitter(
                ids, self.seed, round_idx)
        return base

    def assemble(self, round_idx: int, target: int,
                 candidates: Iterable[np.ndarray],
                 eligible_fn: Optional[Callable[[np.ndarray], np.ndarray]]
                 = None,
                 deadline_s: Optional[float] = None,
                 over_sample: Optional[float] = None) -> AssemblyResult:
        """Stream candidate-id chunks into a cohort of ≤ ``target``.

        ``eligible_fn(ids) -> bool mask`` vectorizes the deployment's
        predicate over a chunk (the server wraps its online-device
        metadata; synthetic benches wrap a hash). Only ``chunk + target``
        ids are ever live at once."""
        t0 = time.perf_counter()
        target = max(int(target), 0)
        best_ids = np.empty(0, np.int64)
        best_scores = np.empty(0, np.float64)
        scanned = eligible = 0
        for ids in candidates:
            ids = np.asarray(ids, np.int64)
            scanned += len(ids)
            if eligible_fn is not None:
                mask = np.asarray(eligible_fn(ids), bool)
                ids = ids[mask]
            eligible += len(ids)
            if not len(ids) or not target:
                continue
            scores = self._score(round_idx, ids)
            # fold into the running top-k: concat is O(chunk + target),
            # partial_top_k is O(chunk + target + k log k)
            merged_ids = np.concatenate([best_ids, ids])
            merged_scores = np.concatenate([best_scores, scores])
            keep = partial_top_k(merged_scores, target)
            best_ids = merged_ids[keep]
            best_scores = merged_scores[keep]
        wall_ms = (time.perf_counter() - t0) * 1e3
        obs_metrics.record_cohort_assembly(
            wall_ms / 1e3, scanned, eligible, len(best_ids),
            deadline_s=deadline_s, over_sample=over_sample)
        return AssemblyResult(cohort=[int(c) for c in best_ids],
                              scanned=scanned, eligible=eligible,
                              wall_ms=wall_ms, scores=best_scores)


@dataclass
class DeadlinePacer:
    """Oort's deadline-driven pacer: the round deadline T and the cohort
    over-sample factor move together from observed round outcomes.

    A round that closes with fewer than ``target_frac`` of its expected
    reports by the deadline was paced too aggressively: stretch T and
    over-sample harder (more redundancy absorbs the stragglers). A round
    that delivers everything in well under T was paced too timidly:
    tighten both. Multiplicative steps, hard bounds, no RNG — the
    trajectory is a pure function of the observation sequence, which is
    what makes pacing assertable in tests."""

    deadline_s: float = 60.0
    over_sample: float = 1.3
    target_frac: float = 0.8
    step: float = 0.2
    min_deadline_s: float = 1.0
    max_deadline_s: float = 3600.0
    max_over_sample: float = 3.0
    rounds_observed: int = field(default=0)
    # --- utility-driven cohort sizing (pacer_adapt_cohort; off = the
    # configured k never moves — paced_cohort() is the identity) -------
    adapt_cohort: bool = False
    cohort_scale: float = 1.0
    min_cohort_scale: float = 1.0
    max_cohort_scale: float = 4.0
    util_window: int = 4
    util_saturation: float = 0.05
    _util_hist: List[float] = field(default_factory=list)

    @classmethod
    def from_args(cls, args) -> "DeadlinePacer":
        deadline = float(getattr(args, "pacer_deadline_s", 0) or 0)
        if deadline <= 0:
            deadline = float(getattr(args, "round_timeout_s", 0) or 0) \
                or 60.0
        return cls(
            deadline_s=deadline,
            over_sample=float(getattr(args, "pacer_over_sample", 1.3)
                              or 1.3),
            target_frac=float(getattr(args, "pacer_target_frac", 0.8)
                              or 0.8),
            step=float(getattr(args, "pacer_step", 0.2) or 0.2),
            min_deadline_s=float(getattr(args, "pacer_min_deadline_s", 1.0)
                                 or 1.0),
            max_deadline_s=float(getattr(args, "pacer_max_deadline_s",
                                         3600.0) or 3600.0),
            max_over_sample=float(getattr(args, "pacer_max_over_sample",
                                          3.0) or 3.0),
            adapt_cohort=bool(getattr(args, "pacer_adapt_cohort", False)),
            min_cohort_scale=float(getattr(args, "pacer_min_cohort_scale",
                                           1.0) or 1.0),
            max_cohort_scale=float(getattr(args, "pacer_max_cohort_scale",
                                           4.0) or 4.0),
            util_window=max(int(getattr(args, "pacer_util_window", 4)
                                or 4), 1),
            util_saturation=float(getattr(args, "pacer_util_saturation",
                                          0.05) or 0.05))

    def target_cohort(self, k: int, ceiling: Optional[int] = None) -> int:
        """Over-sampled dispatch size for a wanted cohort of ``k``."""
        t = int(np.ceil(max(int(k), 1) * self.over_sample))
        if ceiling is not None:
            t = min(t, int(ceiling))
        return max(t, 1)

    def paced_cohort(self, k: int) -> int:
        """The live cohort size for a configured k: identity unless
        ``adapt_cohort`` is on, else k scaled by the utility-driven
        ``cohort_scale`` (bounded; callers still ceiling by population)."""
        k = max(int(k), 1)
        if not self.adapt_cohort:
            return k
        return max(int(round(k * self.cohort_scale)), 1)

    def observe_utility(self, utility: float) -> None:
        """One round's aggregate statistical utility (the assembled
        cohort's summed scores). Every ``util_window`` observations the
        pacer compares the window mean against the previous window:
        saturation (no relative improvement past ``util_saturation``)
        grows the cohort scale — more devices per round keep progress
        moving once per-device utility plateaus (Oort's rule) — while a
        still-improving utility decays the scale back toward 1× (the
        configured k already harvests well). No-op when adaptation is
        off, so default-path trajectories carry no hidden state."""
        if not self.adapt_cohort:
            return
        self._util_hist.append(float(utility))
        w = self.util_window
        if len(self._util_hist) < 2 * w:
            return
        prev = float(np.mean(self._util_hist[-2 * w:-w]))
        cur = float(np.mean(self._util_hist[-w:]))
        rel = (cur - prev) / max(abs(prev), 1e-12)
        if rel <= self.util_saturation:
            self.cohort_scale = min(self.cohort_scale * (1.0 + self.step),
                                    self.max_cohort_scale)
        else:
            self.cohort_scale = max(self.cohort_scale * (1.0 - self.step / 2),
                                    self.min_cohort_scale)
        # the decided-on window becomes the next comparison's baseline
        self._util_hist = self._util_hist[-w:]

    def observe_round(self, completed: int, expected: int,
                      wall_s: float) -> None:
        """One closed round: ``completed`` of ``expected`` dispatched
        devices reported within ``wall_s``."""
        self.rounds_observed += 1
        expected = max(int(expected), 1)
        frac = min(max(int(completed), 0) / expected, 1.0)
        if frac < self.target_frac:
            # under-delivered: stretch the deadline AND over-sample more
            self.deadline_s = min(self.deadline_s * (1.0 + self.step),
                                  self.max_deadline_s)
            self.over_sample = min(self.over_sample * (1.0 + self.step),
                                   self.max_over_sample)
        elif frac >= 1.0 and wall_s <= 0.5 * self.deadline_s:
            # everyone reported in half the budget: pace up
            self.deadline_s = max(self.deadline_s * (1.0 - self.step / 2),
                                  self.min_deadline_s)
            self.over_sample = max(self.over_sample * (1.0 - self.step / 2),
                                   1.0)

    def state_dict(self) -> dict:
        # util_hist rides as a FIXED [2 * util_window] NaN-padded array:
        # template-based checkpoint restores (orbax-style) need stable
        # shapes between save and resume
        hist = np.full(2 * self.util_window, np.nan, np.float64)
        tail = self._util_hist[-len(hist):]
        if tail:
            hist[:len(tail)] = tail
        return {"deadline_s": np.float64(self.deadline_s),
                "over_sample": np.float64(self.over_sample),
                "rounds_observed": np.int64(self.rounds_observed),
                "cohort_scale": np.float64(self.cohort_scale),
                "util_hist": hist}

    def load_state_dict(self, state: dict) -> None:
        self.deadline_s = float(state["deadline_s"])
        self.over_sample = float(state["over_sample"])
        self.rounds_observed = int(state["rounds_observed"])
        # cohort-sizing fields postdate checkpoints in the wild: absent
        # means "resume with the configured scale", never a refusal
        if "cohort_scale" in state:
            self.cohort_scale = float(state["cohort_scale"])
        if "util_hist" in state:
            hist = np.asarray(state["util_hist"], np.float64).reshape(-1)
            self._util_hist = [float(v) for v in hist[np.isfinite(hist)]]
