"""Sparse/lazy client statistics — the million-client store backend.

The dense :class:`~fedml_tpu_torch.core.selection.stats.ClientStatsStore`
allocates ``[N]`` NumPy state per signal and answers queries with
full-population reads — the right shape for 10–100 simulated clients or
silo ranks, five orders of magnitude wrong for a Beehive-scale
cross-device population (SURVEY §2.5). This backend keeps the SAME
observation/query API but materializes state only for *touched* clients:

* an id → row dict over **columnar** NumPy arrays that grow by
  amortized doubling (compaction keeps rows contiguous, so the
  vectorized query math is identical to the dense store's — same ops on
  the same dtypes);
* Beta/EMA posteriors exist only for observed ids; untouched ids answer
  with the exact dense-store defaults (work 1.0, loss +inf/NaN,
  reputation 1.0, the prior dropout mean, ``last_selected`` −1);
* pooled reductions (population dropout mean, the reputation cohort
  mean, Oort's RMS fill) run over observed rows in ascending-id order —
  the same canonical order the dense store now uses — so posteriors and
  therefore selections are **bit-identical** across backends given the
  same observations;
* an optional row ``capacity`` bounds memory on unbounded populations:
  a full table evicts the least-recently-touched row (deterministic
  given the observation order, so crash-resume still replays).

Checkpointing: ``state_dict`` emits the compacted columns plus the row
→ id map; ``load_state_dict`` accepts that layout OR a legacy **dense**
snapshot (``[N]`` arrays, no ``ids`` key), converting touched rows on
the fly — existing checkpoints stay restorable after a backend switch.
Orbax ``StandardRestore`` returns saved shapes even when the template's
row count differs (pinned by ``tests/test_population.py``), so the
growing columns ride :class:`~fedml_tpu_torch.core.checkpoint.RoundCheckpointer`
unchanged.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, Optional, Sequence

import numpy as np

from .stats import DROP_PRIOR_A, DROP_PRIOR_B, ClientStatsStore

logger = logging.getLogger(__name__)

_MIN_ROWS = 64


class SparseClientStatsStore:
    """Touched-client statistics over a population of ``n`` ids. Same
    observation/query API as :class:`ClientStatsStore`; cost scales with
    touched clients and query-batch size, never with ``n``."""

    def __init__(self, num_clients: int, loss_window: int = 8,
                 ema_alpha: float = 0.2,
                 drop_prior: tuple = (DROP_PRIOR_A, DROP_PRIOR_B),
                 capacity: int = 0):
        n = int(num_clients)
        if n <= 0:
            raise ValueError("SparseClientStatsStore needs a positive "
                             "population")
        self.n = n
        self.loss_window = max(int(loss_window), 1)
        self.ema_alpha = float(ema_alpha)
        self.drop_prior_a = float(drop_prior[0])
        self.drop_prior_b = float(drop_prior[1])
        # 0 = unbounded (rows track touched clients); > 0 caps rows with
        # least-recently-touched eviction
        self.capacity = max(int(capacity or 0), 0)
        self._index: Dict[int, int] = {}
        self._size = 0
        self._touch_clock = 0
        self._warned: set = set()
        # lazily-rebuilt sorted view for vectorized batch lookups
        # (np.searchsorted beats len(ids) dict gets by ~50x on the
        # chunked assembly scan); invalidated on any row insert/evict
        self._sorted_ids: Optional[np.ndarray] = None
        self._sorted_rows: Optional[np.ndarray] = None
        self._alloc(_MIN_ROWS if not self.capacity
                    else min(_MIN_ROWS, self.capacity))

    # --- row storage --------------------------------------------------------
    def _alloc(self, rows: int) -> None:
        w = self.loss_window
        self.ids = np.full(rows, -1, np.int64)
        self.last_touch = np.zeros(rows, np.int64)
        self.losses = np.zeros((rows, w), np.float32)
        self.loss_count = np.zeros(rows, np.int32)
        self.loss_ptr = np.zeros(rows, np.int32)
        self.ema_latency = np.zeros(rows, np.float32)
        self.has_latency = np.zeros(rows, np.float32)
        self.ema_interarrival = np.zeros(rows, np.float32)
        self.arr_obs = np.zeros(rows, np.float32)
        self.ema_work = np.ones(rows, np.float32)
        self.drop_obs = np.zeros(rows, np.float32)
        self.part_obs = np.zeros(rows, np.float32)
        self.incl_obs = np.zeros(rows, np.float32)
        self.excl_obs = np.zeros(rows, np.float32)
        self.times_selected = np.zeros(rows, np.int32)
        self.last_selected = np.full(rows, -1, np.int32)

    _COLUMNS = ("ids", "last_touch", "losses", "loss_count", "loss_ptr",
                "ema_latency", "has_latency", "ema_interarrival", "arr_obs",
                "ema_work", "drop_obs", "part_obs", "incl_obs", "excl_obs",
                "times_selected", "last_selected")

    def _grow(self) -> None:
        new_rows = max(len(self.ids) * 2, _MIN_ROWS)
        if self.capacity:
            new_rows = min(new_rows, self.capacity)
        for f in self._COLUMNS:
            cur = getattr(self, f)
            fresh = np.zeros((new_rows,) + cur.shape[1:], cur.dtype)
            if f == "ids":
                fresh[:] = -1
            elif f == "ema_work":
                fresh[:] = 1.0
            elif f == "last_selected":
                fresh[:] = -1
            fresh[:self._size] = cur[:self._size]
            setattr(self, f, fresh)

    def _reset_row(self, r: int, cid: int) -> None:
        self.ids[r] = cid
        self.last_touch[r] = 0
        self.losses[r] = 0.0
        self.loss_count[r] = 0
        self.loss_ptr[r] = 0
        self.ema_latency[r] = 0.0
        self.has_latency[r] = 0.0
        self.ema_interarrival[r] = 0.0
        self.arr_obs[r] = 0.0
        self.ema_work[r] = 1.0
        self.drop_obs[r] = 0.0
        self.part_obs[r] = 0.0
        self.incl_obs[r] = 0.0
        self.excl_obs[r] = 0.0
        self.times_selected[r] = 0
        self.last_selected[r] = -1

    def _row(self, client_id: int) -> int:
        """Row of ``client_id``, creating (and LRU-evicting at capacity)
        on first touch."""
        cid = int(client_id)
        r = self._index.get(cid)
        if r is None:
            if self.capacity and self._size >= self.capacity:
                # deterministic eviction: the least-recently-touched row
                # (ties broken by row order, which is insertion order)
                r = int(np.argmin(self.last_touch[:self._size]))
                del self._index[int(self.ids[r])]
                self._reset_row(r, cid)
            else:
                if self._size >= len(self.ids):
                    self._grow()
                r = self._size
                self._size += 1
                self.ids[r] = cid
            self._index[cid] = r
            self._sorted_ids = None  # membership changed
        self._touch_clock += 1
        self.last_touch[r] = self._touch_clock
        return r

    def _rows_for(self, ids: Sequence[int]) -> tuple:
        """(row index or -1 per id, found mask) — read-only vectorized
        lookup via the sorted view; no row creation, no eviction-clock
        advance."""
        ids = np.asarray(ids, np.int64)
        if self._size == 0:
            return np.full(len(ids), -1, np.int64), np.zeros(len(ids),
                                                             bool)
        if self._sorted_ids is None:
            present = self.ids[:self._size]
            order = np.argsort(present, kind="stable")
            self._sorted_ids = present[order]
            self._sorted_rows = order.astype(np.int64)
        pos = np.minimum(np.searchsorted(self._sorted_ids, ids),
                         len(self._sorted_ids) - 1)
        found = self._sorted_ids[pos] == ids
        rows = np.where(found, self._sorted_rows[pos], -1)
        return rows, found

    # --- observations (same contracts as the dense store) -------------------
    def record_selected(self, round_idx: int, ids: Sequence[int]) -> None:
        for cid in ids:
            r = self._row(cid)
            self.times_selected[r] += 1
            self.last_selected[r] = int(round_idx)

    def record_availability(self, client_id: int, participated: bool,
                            work: float = 1.0) -> None:
        r = self._row(client_id)
        if participated:
            self.part_obs[r] += 1.0
            a = self.ema_alpha
            self.ema_work[r] = (1.0 - a) * self.ema_work[r] + a * float(work)
        else:
            self.drop_obs[r] += 1.0

    def record_loss(self, client_id: int, loss: float) -> None:
        loss = float(loss)
        if not np.isfinite(loss):
            return
        r = self._row(client_id)
        p = int(self.loss_ptr[r])
        self.losses[r, p] = loss
        self.loss_ptr[r] = (p + 1) % self.loss_window
        self.loss_count[r] = self.loss_count[r] + 1

    def record_latency(self, client_id: int, latency_s: float) -> None:
        lat = float(latency_s)
        if not np.isfinite(lat) or lat < 0.0:
            return
        r = self._row(client_id)
        if self.has_latency[r] > 0:
            a = self.ema_alpha
            self.ema_latency[r] = (1.0 - a) * self.ema_latency[r] + a * lat
        else:
            self.ema_latency[r] = lat
            self.has_latency[r] = 1.0

    def record_arrival(self, client_id: int, interarrival_s: float) -> None:
        gap = float(interarrival_s)
        if not np.isfinite(gap) or gap <= 0.0:
            return
        r = self._row(client_id)
        if self.arr_obs[r] > 0:
            a = self.ema_alpha
            self.ema_interarrival[r] = ((1.0 - a) * self.ema_interarrival[r]
                                        + a * gap)
        else:
            self.ema_interarrival[r] = gap
        self.arr_obs[r] += 1.0

    def record_verdict(self, ids: Sequence[int],
                       verdict: Sequence[float]) -> None:
        ids = list(ids)
        v = np.clip(np.asarray(list(verdict), np.float32), 0.0, 1.0)
        if not ids or len(ids) != v.size:
            return
        for cid, vi in zip(ids, v):
            r = self._row(cid)
            self.incl_obs[r] += float(vi)
            self.excl_obs[r] += 1.0 - float(vi)

    # --- id-parameterized queries -------------------------------------------
    def last_loss_for(self, ids: Sequence[int]) -> np.ndarray:
        rows, found = self._rows_for(ids)
        r = np.where(found, rows, 0)
        seen = found & (self.loss_count[r] > 0)
        idx = (self.loss_ptr[r] - 1) % self.loss_window
        last = self.losses[r, idx]
        return np.where(seen, last, np.inf).astype(np.float32)

    def rms_loss_for(self, ids: Sequence[int]) -> np.ndarray:
        rows, found = self._rows_for(ids)
        r = np.where(found, rows, 0)
        k = np.where(found, np.minimum(self.loss_count[r],
                                       self.loss_window), 0)
        with np.errstate(invalid="ignore", divide="ignore"):
            ms = np.sum(self.losses[r] ** 2, axis=1) / np.maximum(k, 1)
        return np.where(k > 0, np.sqrt(ms), np.nan).astype(np.float32)

    def reputation_for(self, ids: Sequence[int]) -> np.ndarray:
        rows, found = self._rows_for(ids)
        r = np.where(found, rows, 0)
        obs = np.where(found, self.incl_obs[r] + self.excl_obs[r], 0.0)
        raw = (1.0 + np.where(found, self.incl_obs[r], 0.0)) / (2.0 + obs)
        pop = self._reputation_pop_mean()
        if pop is None:
            return np.ones(len(raw), np.float32)
        rep = np.clip(raw / max(pop, 1e-9), 0.0, 1.0)
        return np.where(obs > 0, rep, 1.0).astype(np.float32)

    def _reputation_pop_mean(self) -> Optional[float]:
        s = self._size
        obs = self.incl_obs[:s] + self.excl_obs[:s]
        seen = obs > 0
        if not bool(np.any(seen)):
            return None
        # ascending-id order: the dense store's boolean-mask selection
        # walks ids ascending, so sorting here makes np.mean's pairwise
        # tree identical — the bit-parity contract
        order = np.argsort(self.ids[:s][seen], kind="stable")
        raw = ((1.0 + self.incl_obs[:s][seen]) / (2.0 + obs[seen]))[order]
        return float(np.mean(raw))

    def ema_work_for(self, ids: Sequence[int]) -> np.ndarray:
        rows, found = self._rows_for(ids)
        r = np.where(found, rows, 0)
        return np.where(found, self.ema_work[r], 1.0).astype(np.float32)

    def latency_for(self, ids: Sequence[int]) -> np.ndarray:
        rows, found = self._rows_for(ids)
        r = np.where(found, rows, 0)
        return np.where(found & (self.has_latency[r] > 0),
                        self.ema_latency[r], np.nan).astype(np.float32)

    def times_selected_for(self, ids: Sequence[int]) -> np.ndarray:
        rows, found = self._rows_for(ids)
        r = np.where(found, rows, 0)
        return np.where(found, self.times_selected[r], 0).astype(np.int32)

    def last_selected_for(self, ids: Sequence[int]) -> np.ndarray:
        rows, found = self._rows_for(ids)
        r = np.where(found, rows, 0)
        return np.where(found, self.last_selected[r], -1).astype(np.int32)

    def observed_rms_mean(self) -> float:
        s = self._size
        seen = self.loss_count[:s] > 0
        if not bool(np.any(seen)):
            return float("nan")
        ids = np.sort(self.ids[:s][seen])
        return float(np.mean(self.rms_loss_for(ids)))

    def observed_latency_median(self) -> float:
        s = self._size
        seen = self.has_latency[:s] > 0
        if not bool(np.any(seen)):
            return float("nan")
        return float(np.median(self.ema_latency[:s][seen]))

    def num_touched(self) -> int:
        return self._size

    def touched_ids(self) -> np.ndarray:
        """Ascending ids of ever-touched clients — O(size log size) on
        this backend (the row → id map IS the answer), never O(n)."""
        return np.sort(self.ids[:self._size].astype(np.int64))

    # --- pooled / whole-population queries ----------------------------------
    def dropout_posterior_mean(self,
                               ids: Optional[Iterable[int]] = None
                               ) -> np.ndarray:
        if ids is None:
            # the [n] materialization is the dense callers' surface; a
            # million-client caller passes ids
            self._warn_materialize("dropout_posterior_mean")
            ids = np.arange(self.n)
        rows, found = self._rows_for(list(ids))
        r = np.where(found, rows, 0)
        a = self.drop_prior_a + np.where(found, self.drop_obs[r], 0.0)
        b = self.drop_prior_b + np.where(found, self.part_obs[r], 0.0)
        return (a / (a + b)).astype(np.float32)

    def population_dropout_mean(self) -> float:
        s = self._size
        seen = (self.drop_obs[:s] > 0) | (self.part_obs[:s] > 0)
        order = np.argsort(self.ids[:s][seen], kind="stable")
        a = self.drop_prior_a + float(np.sum(self.drop_obs[:s][seen][order]))
        b = self.drop_prior_b + float(np.sum(self.part_obs[:s][seen][order]))
        return float(a / (a + b))

    def _warn_materialize(self, what: str) -> None:
        """Once per (store, query): whole-population reads exist for
        dense-API compatibility (the async engine's dispatch ranking)
        but defeat the sparse backend's point — say so, once, instead
        of spamming every dispatch."""
        if what not in self._warned:
            self._warned.add(what)
            logger.warning("%s materializes the full population (%d); "
                           "population-scale callers use the "
                           "id-parameterized queries", what, self.n)

    @property
    def reputation(self) -> np.ndarray:
        """[n] normalized inclusion posterior — dense-API compatibility
        read; materializes [n] (warned once)."""
        self._warn_materialize("reputation")
        return self.reputation_for(np.arange(self.n))

    def arrival_rate(self) -> np.ndarray:
        """[n] arrivals per unit time — the async engine's whole-
        population read; materializes [n] (warned once). Population-
        scale callers use :meth:`arrival_rate_for`."""
        self._warn_materialize("arrival_rate")
        return self.arrival_rate_for(np.arange(self.n))

    def last_loss(self) -> np.ndarray:
        """[n] most recent loss — dense-API compatibility read (the
        async dispatch ranking); materializes [n] (warned once)."""
        self._warn_materialize("last_loss")
        return self.last_loss_for(np.arange(self.n))

    def rms_loss(self) -> np.ndarray:
        """[n] RMS loss window — dense-API compatibility read;
        materializes [n] (warned once)."""
        self._warn_materialize("rms_loss")
        return self.rms_loss_for(np.arange(self.n))

    def predicted_staleness(self, pour_interval_s: float) -> np.ndarray:
        """[n] expected model-version lag (dense-store contract: NaN for
        never-observed clients); materializes [n]."""
        if not np.isfinite(pour_interval_s) or pour_interval_s <= 0.0:
            return np.full(self.n, np.nan, np.float32)
        rows, found = self._rows_for(np.arange(self.n))
        r = np.where(found, rows, 0)
        out = self.ema_interarrival[r] / np.float32(pour_interval_s)
        return np.where(found & (self.arr_obs[r] > 0), out,
                        np.nan).astype(np.float32)

    def arrival_rate_for(self, ids: Sequence[int]) -> np.ndarray:
        rows, found = self._rows_for(ids)
        r = np.where(found, rows, 0)
        with np.errstate(divide="ignore"):
            rate = np.where(self.ema_interarrival[r] > 0,
                            1.0 / self.ema_interarrival[r], 0.0)
        return np.where(found & (self.arr_obs[r] > 0), rate,
                        0.0).astype(np.float32)

    # --- persistence --------------------------------------------------------
    def state_dict(self) -> Dict[str, np.ndarray]:
        """Compacted columns (rows [0, size)) + the row → id map. A
        fraction of the dense snapshot's bytes at population scale —
        and the shapes say how many clients were ever touched."""
        s = self._size
        out = {f: np.asarray(getattr(self, f)[:s]).copy()
               for f in self._COLUMNS}
        out["touch_clock"] = np.asarray(self._touch_clock, np.int64)
        return out

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        state = dict(state)
        if "ids" not in state:
            self._load_dense(state)
            return
        ids = np.asarray(state["ids"], np.int64).reshape(-1)
        rows = len(ids)
        if rows and int(np.max(ids)) >= self.n:
            raise ValueError(
                f"sparse selection state touches client "
                f"{int(np.max(ids))}, outside this population of {self.n}")
        if self.capacity and rows > self.capacity:
            raise ValueError(
                f"sparse selection state has {rows} rows, over this "
                f"store's capacity {self.capacity}")
        alloc = _MIN_ROWS
        while alloc < rows:
            alloc *= 2
        self._alloc(alloc)
        for f in self._COLUMNS:
            if f not in state:
                raise ValueError(f"sparse selection state missing {f!r}")
            cur = getattr(self, f)
            val = np.asarray(state[f], cur.dtype)
            want = (rows,) + cur.shape[1:]
            if val.shape != want:
                raise ValueError(
                    f"sparse selection state field {f!r} has shape "
                    f"{val.shape}, expected {want} (loss-window mismatch "
                    "with the checkpoint?)")
            cur[:rows] = val
        self._size = rows
        self._index = {int(c): i for i, c in enumerate(ids)}
        self._sorted_ids = None
        self._touch_clock = int(state.get("touch_clock", rows))

    def _load_dense(self, state: Dict[str, np.ndarray]) -> None:
        """Restore from a legacy DENSE snapshot: materialize rows for the
        touched clients only."""
        dense = ClientStatsStore(self.n, loss_window=self.loss_window,
                                 ema_alpha=self.ema_alpha,
                                 drop_prior=(self.drop_prior_a,
                                             self.drop_prior_b))
        dense.load_state_dict(state)
        touched = np.flatnonzero(dense._touched_mask())
        alloc = _MIN_ROWS
        while alloc < len(touched):
            alloc *= 2
        if self.capacity and len(touched) > self.capacity:
            raise ValueError(
                f"dense selection snapshot touches {len(touched)} clients, "
                f"over this sparse store's capacity {self.capacity}")
        self._alloc(alloc)
        for i, cid in enumerate(touched):
            for f in ClientStatsStore._FIELDS:
                getattr(self, f)[i] = getattr(dense, f)[cid]
            self.ids[i] = int(cid)
            self.last_touch[i] = i + 1
        self._size = len(touched)
        self._index = {int(c): i for i, c in enumerate(touched)}
        self._sorted_ids = None
        self._touch_clock = len(touched)
        logger.info("sparse selection store restored from a dense "
                    "snapshot: %d touched of %d clients",
                    len(touched), self.n)

    def to_dense(self) -> ClientStatsStore:
        """Materialize a dense twin (tests' parity oracle; small n only)."""
        dense = ClientStatsStore(self.n, loss_window=self.loss_window,
                                 ema_alpha=self.ema_alpha,
                                 drop_prior=(self.drop_prior_a,
                                             self.drop_prior_b))
        for cid, r in self._index.items():
            for f in ClientStatsStore._FIELDS:
                getattr(dense, f)[cid] = getattr(self, f)[r]
        return dense
