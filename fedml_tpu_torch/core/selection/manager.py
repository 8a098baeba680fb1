"""SelectionManager — the engine/server-facing seam of the subsystem (a
copy of ``fedml_tpu/core/selection/manager.py`` with one change: the queue
holds torch tensors, and :meth:`SelectionManager._flush` reads every
queued tensor back in ONE ``.cpu()`` copy, since ``np.asarray`` of a CUDA
tensor raises).

Owns the :class:`ClientStatsStore` + the configured strategy and mediates
two directions of flow:

* **observations in**: host-side schedule facts (who was scheduled, who
  the chaos plan dropped, work fractions) are recorded immediately;
  DEVICE-side facts (per-slot training losses, defense verdicts) are
  queued as device arrays and materialized lazily at the next selection
  query — ``run_round`` itself never forces a device→host transfer, so
  the fused single-dispatch property (and the transfer-guard tests that
  pin it) survive selection.
* **selections out**: ``select(round_idx, n)`` flushes the queue and asks
  the strategy; ``round_target`` sizes the cohort from the pooled
  Beta-posterior dropout estimate when adaptive over-sampling is on.

With the default knobs (``client_selection: uniform``, adaptive
over-sampling off) the manager is PASSIVE: it records nothing, queues
nothing, adds no checkpoint state, and delegates straight to the legacy
sampling stream — schedules are bit-identical to a build without the
subsystem.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import sink
from .sparse import SparseClientStatsStore
from .stats import ClientStatsStore
from .strategies import (DEFAULT_POOL_THRESHOLD, SELECTION_STRATEGIES,
                         create_strategy)

logger = logging.getLogger(__name__)

STORE_BACKENDS = ("auto", "dense", "sparse")


def make_stats_store(args, num_clients: int, **store_kw):
    """The ONE ``selection_store`` knob reading (``auto``/``dense``/
    ``sparse``), shared by the engine manager and the cross-device
    cohort plane. ``auto`` (default) keeps the dense backend — O(N)
    state, whole-population reads — below
    ``selection_sparse_threshold`` clients and flips to the sparse
    backend above it, where dense allocation alone would dwarf the
    round. ``selection_store_capacity`` (sparse only) caps rows with
    least-recently-touched eviction."""
    backend = str(getattr(args, "selection_store", "auto")
                  or "auto").lower()
    if backend not in STORE_BACKENDS:
        raise ValueError(f"selection_store {backend!r} unknown; choose "
                         f"from {STORE_BACKENDS}")
    n = int(num_clients)
    if backend == "auto":
        threshold = int(getattr(args, "selection_sparse_threshold",
                                DEFAULT_POOL_THRESHOLD)
                        or DEFAULT_POOL_THRESHOLD)
        backend = "sparse" if n >= threshold else "dense"
    if backend == "sparse":
        cap = int(getattr(args, "selection_store_capacity", 0) or 0)
        logger.info("selection stats: sparse backend over %d clients"
                    "%s", n, f" (capacity {cap})" if cap else "")
        return SparseClientStatsStore(n, capacity=cap, **store_kw)
    return ClientStatsStore(n, **store_kw)

# slot placement: client k of the sampled list lands on device
# cid // cpd at that device's next free slot — the SAME loop as
# build_schedule / the engine's _robust_rows, so (device, slot) -> client
# mapping is shared by schedules, update rows, and slot metrics
def slot_placement(sampled: Sequence[int], n_devices: int,
                   cpd: int) -> List[Tuple[int, int, int]]:
    counts = [0] * n_devices
    out = []
    for cid in sampled:
        d = int(cid) // cpd
        out.append((int(cid), d, counts[d]))
        counts[d] += 1
    return out


class SelectionManager:
    def __init__(self, args, num_clients: int):
        self.args = args
        self.num_clients = int(num_clients)
        self.strategy_name = str(getattr(args, "client_selection", "uniform")
                                 or "uniform").lower()
        if self.strategy_name not in SELECTION_STRATEGIES:
            raise ValueError(
                f"client_selection {self.strategy_name!r} unknown; choose "
                f"from {SELECTION_STRATEGIES}")
        self.adaptive = bool(getattr(args, "selection_adaptive_oversample",
                                     False))
        self.store = make_stats_store(
            args, self.num_clients,
            loss_window=int(getattr(args, "selection_loss_window", 8) or 8),
            ema_alpha=float(getattr(args, "selection_ema_alpha", 0.2)
                            or 0.2))
        self.strategy = create_strategy(args, self.num_clients, self.store)
        # passive at defaults: nothing observed, nothing checkpointed
        self.track = self.strategy_name != "uniform" or self.adaptive
        self._pending: List[Dict[str, Any]] = []
        self._excluded_by_round: Dict[int, set] = {}

    @property
    def stateful(self) -> bool:
        """True when selections depend on observed history — the store
        must then ride checkpoints so crash-resume replays identical
        cohorts."""
        return self.track

    def pin_adaptive(self, reason: str) -> None:
        """Disable adaptive cohort sizing (engine constraint — e.g. the
        fused robust program's [K] defense-kernel shape must stay
        constant for compile-once). Recomputes passivity: a uniform
        strategy that only tracked FOR adaptivity goes fully passive."""
        if not self.adaptive:
            return
        logger.warning("selection_adaptive_oversample disabled: %s",
                       reason)
        self.adaptive = False
        self.track = self.strategy_name != "uniform"

    # --- selections out -----------------------------------------------------
    def round_target(self, round_idx: int, base_n: int, cap_n: int) -> int:
        """Cohort size for this round. Adaptive over-sampling replaces the
        static ``chaos_over_sample`` factor with the pooled posterior
        dropout estimate: sample ``ceil(k / (1 - p))`` so the expected
        post-dropout cohort still hits ``k`` — capped at ``cap_n`` (the
        canonical-width cap: the compiled schedule shapes never move)."""
        if not self.adaptive:
            return int(base_n)
        self._flush()
        p = self.store.population_dropout_mean()
        n = int(np.ceil(base_n / max(1.0 - p, 0.5)))
        return int(min(max(n, base_n), cap_n))

    def select(self, round_idx: int, n: int) -> Tuple[List[int], List[int]]:
        if self.track:
            self._flush()
        return self.strategy.select(round_idx, int(n))

    # --- observations in ----------------------------------------------------
    def note_schedule(self, round_idx: int, sampled: Sequence[int],
                      excluded: Sequence[int], work_by_client: Dict[int,
                                                                    float],
                      target_n: int) -> None:
        """Host-side facts, recorded immediately (no device readback):
        selection, availability outcomes (chaos dropout / straggler work),
        and the obs sink's selection record."""
        if not self.track:
            return
        excl = set(int(c) for c in excluded)
        self._excluded_by_round[int(round_idx)] = excl
        for r in [r for r in self._excluded_by_round
                  if r < int(round_idx) - 64]:  # bound: verdicts consume
            del self._excluded_by_round[r]      # entries; prune strays
        self.store.record_selected(round_idx, sampled)
        for cid in sampled:
            if int(cid) in excl:
                continue  # we benched them: not reliability evidence
            w = float(work_by_client.get(int(cid), 1.0))
            self.store.record_availability(int(cid), participated=w > 0.0,
                                           work=w)
        sink.log_selection(
            round_idx=int(round_idx), strategy=self.strategy_name,
            sampled=[int(c) for c in sampled],
            excluded=sorted(excl), target_n=int(target_n),
            dropout_posterior=round(self.store.population_dropout_mean(),
                                    5))

    def note_results(self, round_idx: int, sampled: Sequence[int],
                     placement: Sequence[Tuple[int, int, int]],
                     slot_metrics: Optional[Any] = None,
                     verdict: Optional[Any] = None) -> None:
        """Device-side facts (per-slot metrics pytree [n_dev, S] leaves,
        defense verdict [K]) queued WITHOUT materializing — flushed at the
        next selection query."""
        if not self.track:
            return
        self._pending.append({
            "round_idx": int(round_idx),
            "sampled": [int(c) for c in sampled],
            "placement": list(placement),
            "slot_metrics": slot_metrics,
            "verdict": verdict,
        })

    def note_latency(self, client_id: int, latency_s: float) -> None:
        if self.track:
            self.store.record_latency(client_id, latency_s)

    def note_arrival(self, client_id: int, interarrival_s: float) -> None:
        """Buffered-async arrival gap — the arrival-rate posterior's
        evidence stream (async engine / cross-silo pour loop)."""
        if self.track:
            self.store.record_arrival(client_id, interarrival_s)

    def flush(self) -> None:
        """Materialize queued device-side observations NOW — the async
        engine's dispatch ranking reads the store between pours, outside
        any selection query."""
        self._flush()

    def _flush(self) -> None:
        pending, self._pending = self._pending, []
        host = _read_back(pending)
        for rec, (sm, v) in zip(pending, host):
            if sm is not None:
                loss_sum, count = sm["loss_sum"], sm["count"]
                for cid, d, s in rec["placement"]:
                    c = float(count[d, s])
                    if c > 0:
                        self.store.record_loss(cid,
                                               float(loss_sum[d, s]) / c)
            if v is not None:
                # a BENCHED client's row was empty this round — the
                # defense's verdict about it is vacuous (a zero row looks
                # perfectly innocuous to krum) and must not launder its
                # reputation back up; record evidence for the clients
                # that actually trained only
                excl = self._excluded_by_round.pop(rec["round_idx"], set())
                ids = rec["sampled"]
                keep = [i for i, c in enumerate(ids) if c not in excl]
                if keep:
                    self.store.record_verdict([ids[i] for i in keep],
                                              v[keep])

    # --- persistence --------------------------------------------------------
    def state_dict(self) -> Dict[str, np.ndarray]:
        self._flush()
        return self.store.state_dict()

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        self._pending = []  # superseded by the restored history
        self.store.load_state_dict({k: np.asarray(v)
                                    for k, v in dict(state).items()})


def _read_back(pending: List[Dict[str, Any]]) -> List[Tuple[Any, Any]]:
    """Each queued record's ``(slot_metrics, verdict)`` as host numpy
    (``slot_metrics``: ``{"loss_sum", "count"}`` in their queued shapes).
    Every torch tensor of the queue is flattened into one float32 vector
    and copied to the host at once: one wait for the device, however
    many rounds the queue holds."""
    tensors: List[Any] = []

    def take(a):
        if a is None:
            return None
        if hasattr(a, "detach"):
            tensors.append(a.detach().reshape(-1).float())
            return (len(tensors) - 1, tuple(a.shape))
        return np.asarray(a)

    plan = []
    for rec in pending:
        sm = rec["slot_metrics"]
        plan.append((None if sm is None else
                     {k: take(sm[k]) for k in ("loss_sum", "count")},
                     take(rec["verdict"])))
    flat: List[np.ndarray] = []
    if tensors:
        offs = np.cumsum([0] + [int(t.numel()) for t in tensors])
        buf = tensors[0].new_empty(int(offs[-1]))
        for i, t in enumerate(tensors):
            buf[offs[i]:offs[i + 1]].copy_(t)
        host = buf.cpu().numpy()
        flat = [host[offs[i]:offs[i + 1]] for i in range(len(tensors))]

    def put(x):
        if isinstance(x, tuple):
            return flat[x[0]].reshape(x[1])
        return x

    return [(None if sm is None else {k: put(v) for k, v in sm.items()},
             put(v)) for sm, v in plan]
