"""Per-client observed statistics — the selection subsystem's memory.

Every signal here already flows through the framework and was previously
thrown away at the aggregation seam: per-round training losses (the round
programs' per-slot metrics), observed work fractions and dropouts (the
chaos ``FaultLedger`` seam), cross-silo upload latencies (the server FSM's
broadcast→receipt clock), and defense exclusion verdicts (the robust
pipeline's per-client weights). The store folds them into compact
per-client state:

* ``ema_latency`` / ``ema_work`` — exponential moving averages of observed
  round latency (cross-silo) and completed work fraction (simulator).
* a **Beta-posterior dropout estimate**: ``drop_obs`` / ``part_obs``
  counts over a weakly-informative Beta(1, 19) prior (≈5% prior dropout),
  so one flaky round does not brand a client and a reliable history is not
  erased by one miss. Posterior mean = (a0+drops)/(a0+b0+obs).
* ``losses`` — a last-K ring buffer of observed mean training losses per
  client (Power-of-Choice ranks on the latest, Oort on the RMS).
* ``reputation`` — a NORMALIZED inclusion posterior over defense
  verdicts: each client's Beta-posterior probability of being kept by the
  defense, divided by the cohort mean and clipped to [0, 1]. The
  normalization is load-bearing — selection-style defenses (krum picks m
  of K rows) exclude honest clients every round too, so the absolute
  exclusion rate is meaningless; what brands a byzantine client is being
  excluded consistently MORE than the cohort. Unobserved clients score
  1.0 (innocent until evidence).

All state is plain NumPy arrays, so ``state_dict``/``load_state_dict``
round-trip through :class:`~fedml_tpu_torch.core.checkpoint.RoundCheckpointer`
(orbax ``StandardSave``) and crash-resume replays identical selections.

Two query surfaces coexist:

* the legacy **whole-population** arrays/properties (``reputation``,
  ``last_loss()``, ...) — O(N) reads kept for the dense cross-silo and
  small-simulation callers;
* **id-parameterized** queries (``last_loss_for(ids)``, ...) — the
  candidate-pool surface, O(len(ids)) on both backends. Strategies go
  through these exclusively so a
  :class:`~fedml_tpu_torch.core.selection.sparse.SparseClientStatsStore` can
  stand in for the dense store without ever materializing the
  population.

Population-pooled reductions (``population_dropout_mean``, the
reputation cohort mean, ``observed_rms_mean``) are computed over the
OBSERVED rows in ascending-id order on both backends — same multiset,
same order, same pairwise-summation tree — which is what makes
dense-vs-sparse posterior parity *bit-identical*, not merely close.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import numpy as np

# weakly-informative dropout prior: Beta(1, 19) -> 5% prior mean. Strong
# enough that a single observed dropout doesn't spike the posterior,
# weak enough that ~10 rounds of real behavior dominate it.
DROP_PRIOR_A = 1.0
DROP_PRIOR_B = 19.0


class ClientStatsStore:
    """Observed per-client statistics over a fixed population of ``n``
    clients (or silo ranks). Pure host-side NumPy — observations never
    touch the device, queries are vectorized reads."""

    def __init__(self, num_clients: int, loss_window: int = 8,
                 ema_alpha: float = 0.2,
                 drop_prior: tuple = (DROP_PRIOR_A, DROP_PRIOR_B)):
        n = int(num_clients)
        if n <= 0:
            raise ValueError("ClientStatsStore needs a positive population")
        self.n = n
        self.loss_window = max(int(loss_window), 1)
        self.ema_alpha = float(ema_alpha)
        # dropout-prior strength is a population property: cross-device
        # cohorts see many cheap observations (keep the default heavy
        # prior), cross-silo servers see one observation per slow round
        # (callers pass a lighter prior so benching reacts in rounds,
        # not epochs)
        self.drop_prior_a = float(drop_prior[0])
        self.drop_prior_b = float(drop_prior[1])
        self.losses = np.zeros((n, self.loss_window), np.float32)
        self.loss_count = np.zeros(n, np.int32)   # total losses ever seen
        self.loss_ptr = np.zeros(n, np.int32)     # ring write cursor
        self.ema_latency = np.zeros(n, np.float32)
        self.has_latency = np.zeros(n, np.float32)
        # arrival-rate posterior (buffered-async paths): inter-arrival EMA
        # + observation count per client. 1/EMA is the arrival rate; with
        # the pour interval it predicts a client's typical staleness —
        # what the adaptive staleness cap and async-aware selection read
        self.ema_interarrival = np.zeros(n, np.float32)
        self.arr_obs = np.zeros(n, np.float32)
        self.ema_work = np.ones(n, np.float32)
        self.drop_obs = np.zeros(n, np.float32)   # observed dropouts
        self.part_obs = np.zeros(n, np.float32)   # observed participations
        self.incl_obs = np.zeros(n, np.float32)   # defense kept (verdicts)
        self.excl_obs = np.zeros(n, np.float32)   # defense excluded
        self.times_selected = np.zeros(n, np.int32)
        self.last_selected = np.full(n, -1, np.int32)

    # --- observations -------------------------------------------------------
    def record_selected(self, round_idx: int, ids: Sequence[int]) -> None:
        ids = np.asarray(list(ids), np.int32)
        if ids.size == 0:
            return
        self.times_selected[ids] += 1
        self.last_selected[ids] = int(round_idx)

    def record_availability(self, client_id: int, participated: bool,
                            work: float = 1.0) -> None:
        """One (round, client) availability outcome: feeds the Beta
        posterior and (for participants) the work-fraction EMA. Callers
        must NOT report selector-forced exclusions here — a client the
        selector itself benched is not evidence about its reliability."""
        c = int(client_id)
        if participated:
            self.part_obs[c] += 1.0
            a = self.ema_alpha
            self.ema_work[c] = (1.0 - a) * self.ema_work[c] + a * float(work)
        else:
            self.drop_obs[c] += 1.0

    def record_loss(self, client_id: int, loss: float) -> None:
        c = int(client_id)
        loss = float(loss)
        if not np.isfinite(loss):
            return
        p = int(self.loss_ptr[c])
        self.losses[c, p] = loss
        self.loss_ptr[c] = (p + 1) % self.loss_window
        self.loss_count[c] = self.loss_count[c] + 1

    def record_latency(self, client_id: int, latency_s: float) -> None:
        c = int(client_id)
        lat = float(latency_s)
        if not np.isfinite(lat) or lat < 0.0:
            return
        if self.has_latency[c] > 0:
            a = self.ema_alpha
            self.ema_latency[c] = (1.0 - a) * self.ema_latency[c] + a * lat
        else:
            self.ema_latency[c] = lat
            self.has_latency[c] = 1.0

    def record_arrival(self, client_id: int,
                       interarrival_s: float) -> None:
        """One observed gap between this client's consecutive update
        arrivals (buffered-async paths). The EMA is the arrival-rate
        posterior's point estimate."""
        c = int(client_id)
        gap = float(interarrival_s)
        if not np.isfinite(gap) or gap <= 0.0:
            return
        if self.arr_obs[c] > 0:
            a = self.ema_alpha
            self.ema_interarrival[c] = ((1.0 - a) * self.ema_interarrival[c]
                                        + a * gap)
        else:
            self.ema_interarrival[c] = gap
        self.arr_obs[c] += 1.0

    def arrival_rate(self) -> np.ndarray:
        """[n] arrivals per unit time (1 / inter-arrival EMA); 0 for
        never-observed clients — a client with no arrivals has no rate,
        not an infinite one."""
        with np.errstate(divide="ignore"):
            rate = np.where(self.ema_interarrival > 0,
                            1.0 / self.ema_interarrival, 0.0)
        return np.where(self.arr_obs > 0, rate, 0.0).astype(np.float32)

    def arrival_rate_for(self, ids: Sequence[int]) -> np.ndarray:
        """[len(ids)] arrivals per unit time; 0 for never-observed ids —
        O(len(ids)): index first, divide after (the *_for contract)."""
        ids = np.asarray(ids, np.int64)
        ei = self.ema_interarrival[ids]
        with np.errstate(divide="ignore"):
            rate = np.where(ei > 0, 1.0 / ei, 0.0)
        return np.where(self.arr_obs[ids] > 0, rate, 0.0).astype(np.float32)

    def predicted_staleness(self, pour_interval_s: float) -> np.ndarray:
        """[n] expected model-version lag of each client's next upload:
        inter-arrival EMA over the pour interval. NaN for never-observed
        clients (callers substitute their own prior)."""
        if not np.isfinite(pour_interval_s) or pour_interval_s <= 0.0:
            return np.full(self.n, np.nan, np.float32)
        out = self.ema_interarrival / np.float32(pour_interval_s)
        return np.where(self.arr_obs > 0, out, np.nan).astype(np.float32)

    def record_verdict(self, ids: Sequence[int],
                       verdict: Sequence[float]) -> None:
        """One round's defense verdict ([K] effective inclusion in [0, 1],
        1 = fully kept): accumulate inclusion/exclusion evidence. A
        continuous verdict (foolsgold weights, residual confidences)
        contributes fractionally to both sides."""
        ids = np.asarray(list(ids), np.int32)
        v = np.clip(np.asarray(list(verdict), np.float32), 0.0, 1.0)
        if ids.size == 0 or ids.size != v.size:
            return
        np.add.at(self.incl_obs, ids, v)
        np.add.at(self.excl_obs, ids, 1.0 - v)

    @property
    def reputation(self) -> np.ndarray:
        """[n] normalized inclusion posterior in [0, 1]: the Beta(1, 1)
        posterior mean of P(kept by the defense), divided by the cohort
        mean over OBSERVED clients and clipped. Relative scoring is what
        makes this robust to harsh selection-style defenses (krum keeps m
        of K every round — absolute exclusion rates brand everyone);
        unobserved clients score 1.0."""
        obs = self.incl_obs + self.excl_obs
        raw = (1.0 + self.incl_obs) / (2.0 + obs)
        seen = obs > 0
        pop = self._reputation_pop_mean()
        if pop is None:
            return np.ones(self.n, np.float32)
        rep = np.clip(raw / max(pop, 1e-9), 0.0, 1.0)
        return np.where(seen, rep, 1.0).astype(np.float32)

    # --- id-parameterized queries (the candidate-pool surface) -------------
    # Every *_for query is O(len(ids)) on the sparse backend too; the
    # whole-population reads further down stay for dense callers.
    def last_loss_for(self, ids: Sequence[int]) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        seen = self.loss_count[ids] > 0
        idx = (self.loss_ptr[ids] - 1) % self.loss_window
        last = self.losses[ids, idx]
        return np.where(seen, last, np.inf).astype(np.float32)

    def rms_loss_for(self, ids: Sequence[int]) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        k = np.minimum(self.loss_count[ids], self.loss_window)
        with np.errstate(invalid="ignore", divide="ignore"):
            ms = np.sum(self.losses[ids] ** 2, axis=1) / np.maximum(k, 1)
        return np.where(k > 0, np.sqrt(ms), np.nan).astype(np.float32)

    def reputation_for(self, ids: Sequence[int]) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        obs = self.incl_obs[ids] + self.excl_obs[ids]
        raw = (1.0 + self.incl_obs[ids]) / (2.0 + obs)
        pop = self._reputation_pop_mean()
        if pop is None:
            return np.ones(len(ids), np.float32)
        rep = np.clip(raw / max(pop, 1e-9), 0.0, 1.0)
        return np.where(obs > 0, rep, 1.0).astype(np.float32)

    def _reputation_pop_mean(self) -> Optional[float]:
        """Cohort-mean inclusion posterior over OBSERVED clients in
        ascending-id order (the canonical reduction both backends share);
        None when nobody has a verdict yet."""
        obs = self.incl_obs + self.excl_obs
        seen = obs > 0
        if not bool(np.any(seen)):
            return None
        raw = (1.0 + self.incl_obs[seen]) / (2.0 + obs[seen])
        return float(np.mean(raw))

    def ema_work_for(self, ids: Sequence[int]) -> np.ndarray:
        return self.ema_work[np.asarray(ids, np.int64)]

    def latency_for(self, ids: Sequence[int]) -> np.ndarray:
        """[len(ids)] EMA latency; NaN for never-observed clients."""
        ids = np.asarray(ids, np.int64)
        return np.where(self.has_latency[ids] > 0, self.ema_latency[ids],
                        np.nan).astype(np.float32)

    def times_selected_for(self, ids: Sequence[int]) -> np.ndarray:
        return self.times_selected[np.asarray(ids, np.int64)]

    def last_selected_for(self, ids: Sequence[int]) -> np.ndarray:
        return self.last_selected[np.asarray(ids, np.int64)]

    def observed_rms_mean(self) -> float:
        """Mean RMS loss over clients WITH loss history (ascending-id
        order — the canonical reduction); NaN when nobody has one. Oort's
        neutral fill for unobserved candidates."""
        seen = self.loss_count > 0
        if not bool(np.any(seen)):
            return float("nan")
        ids = np.flatnonzero(seen)
        return float(np.mean(self.rms_loss_for(ids)))

    def observed_latency_median(self) -> float:
        """Median EMA latency over clients WITH a latency observation;
        NaN when nobody has one (Oort's default preferred latency)."""
        seen = self.has_latency > 0
        if not bool(np.any(seen)):
            return float("nan")
        return float(np.median(self.ema_latency[seen]))

    def num_touched(self) -> int:
        """How many clients carry ANY observed evidence — the dense
        backend's answer is a scan; the sparse backend's is its size."""
        return int(np.sum(self._touched_mask()))

    def touched_ids(self) -> np.ndarray:
        """Ascending ids of clients carrying ANY observed evidence — the
        fleet plane's restart diagnostics (which devices does a resumed
        posture actually remember?). Dense backend: a scan."""
        return np.flatnonzero(self._touched_mask()).astype(np.int64)

    def _touched_mask(self) -> np.ndarray:
        return ((self.loss_count > 0) | (self.part_obs > 0)
                | (self.drop_obs > 0) | (self.incl_obs + self.excl_obs > 0)
                | (self.has_latency > 0) | (self.times_selected > 0)
                | (self.arr_obs > 0) | (self.last_selected >= 0))

    # --- queries ------------------------------------------------------------
    def dropout_posterior_mean(self,
                               ids: Optional[Iterable[int]] = None
                               ) -> np.ndarray:
        """Per-client posterior mean dropout probability."""
        a = self.drop_prior_a + self.drop_obs
        b = self.drop_prior_b + self.part_obs
        post = a / (a + b)
        if ids is None:
            return post
        return post[np.asarray(list(ids), np.int32)]

    def population_dropout_mean(self) -> float:
        """POOLED posterior mean over the whole population — the adaptive
        over-sampling signal (per-client posteriors would be noise-
        dominated early; the pooled estimate converges in a few rounds).
        Summed over rows WITH availability evidence in ascending-id order
        (zero rows contribute nothing) so the sparse backend's pooled
        posterior is bit-identical, not merely close."""
        seen = (self.drop_obs > 0) | (self.part_obs > 0)
        a = self.drop_prior_a + float(np.sum(self.drop_obs[seen]))
        b = self.drop_prior_b + float(np.sum(self.part_obs[seen]))
        return float(a / (a + b))

    def last_loss(self) -> np.ndarray:
        """[n] most recently observed loss; +inf for never-observed
        clients (Power-of-Choice treats unknown as maximally interesting —
        exploration falls out for free)."""
        seen = self.loss_count > 0
        idx = (self.loss_ptr - 1) % self.loss_window
        last = self.losses[np.arange(self.n), idx]
        return np.where(seen, last, np.inf).astype(np.float32)

    def rms_loss(self) -> np.ndarray:
        """[n] root-mean-square of the recorded loss window (Oort's
        statistical-utility core); NaN for never-observed clients so the
        strategy can substitute its exploration value."""
        k = np.minimum(self.loss_count, self.loss_window)
        with np.errstate(invalid="ignore", divide="ignore"):
            ms = np.sum(self.losses ** 2, axis=1) / np.maximum(k, 1)
        return np.where(k > 0, np.sqrt(ms), np.nan).astype(np.float32)

    # --- persistence --------------------------------------------------------
    _FIELDS = ("losses", "loss_count", "loss_ptr", "ema_latency",
               "has_latency", "ema_work", "drop_obs", "part_obs",
               "incl_obs", "excl_obs", "times_selected", "last_selected",
               "ema_interarrival", "arr_obs")
    # fields added after checkpoints already existed in the wild: absent
    # from an old state dict means "resume cold", not "refuse to load"
    _OPTIONAL_FIELDS = ("ema_interarrival", "arr_obs")

    def state_dict(self) -> Dict[str, np.ndarray]:
        return {f: np.asarray(getattr(self, f)).copy() for f in self._FIELDS}

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        for f in self._FIELDS:
            if f not in state:
                if f in self._OPTIONAL_FIELDS:
                    continue
                raise ValueError(f"selection state missing field {f!r}")
            cur = getattr(self, f)
            val = np.asarray(state[f], dtype=cur.dtype)
            if val.shape != cur.shape:
                raise ValueError(
                    f"selection state field {f!r} has shape {val.shape}, "
                    f"expected {cur.shape} (population or loss-window "
                    "mismatch with the checkpoint)")
            setattr(self, f, val.copy())
