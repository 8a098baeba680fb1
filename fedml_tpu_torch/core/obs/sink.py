"""Where the obs planes' records go (the port's stand-in for the JAX
package's ``mlops._emit``, which this package does not port yet, and for
its ``log_round_info`` / ``log_chaos`` / ``log_selection`` records).

Spans, metric snapshots and watchdog health records are dicts handed to
:func:`emit`. Nothing is written until a caller installs a sink with
:func:`set_sink` (any callable taking one record dict, e.g. a JSONL
writer), so library use writes nothing outside the caller's control.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

_state: Dict[str, Any] = {"sink": None, "run_id": "0"}


def set_sink(fn: Optional[Callable[[Dict[str, Any]], None]],
             run_id: str = "0") -> None:
    """Install (or, with None, remove) the record sink."""
    _state["sink"] = fn
    _state["run_id"] = str(run_id)


def run_id() -> str:
    return _state["run_id"]


def emit(kind: str, payload: Dict[str, Any]) -> None:
    """Hand one record (``kind``, ``ts``, ``run_id`` added) to the sink."""
    sink = _state["sink"]
    if sink is None:
        return
    rec = dict(payload)
    rec.update({"kind": kind, "ts": time.time(), "run_id": _state["run_id"]})
    sink(rec)


def log_round_info(total_rounds: int, round_idx: int) -> None:
    """A ``kind: round`` record (the JAX package's ``mlops.log_round_info``),
    and the metrics registry's round-boundary clock: the periodic
    ``metrics_snapshot`` (``obs_metrics_flush_rounds``) rides it."""
    from . import metrics as obs_metrics
    emit("round", {"round_idx": int(round_idx),
                   "total_rounds": int(total_rounds)})
    obs_metrics.maybe_flush(int(round_idx))


def log_chaos(round_idx: Optional[int] = None,
              injected: Optional[Dict[str, Any]] = None,
              observed: Optional[Dict[str, Any]] = None,
              arrivals: Optional[list] = None) -> None:
    """A ``kind: chaos`` record of the fault ledger (the JAX package's
    ``mlops.log_chaos``): what the ``FaultPlan`` injected against what the
    round observed. ``arrivals`` carries a buffered-async pour's
    per-update records (client, staleness at aggregation, arrival time,
    dispatch version); they also feed the staleness and buffer-occupancy
    histograms (``metrics.record_pour``)."""
    rec: Dict[str, Any] = {}
    if round_idx is not None:
        rec["round_idx"] = int(round_idx)
    if injected is not None:
        rec["injected"] = injected
    if observed is not None:
        rec["observed"] = observed
    if arrivals is not None:
        from . import metrics as obs_metrics
        rec["arrivals"] = arrivals
        stal = [a.get("staleness", 0) for a in arrivals
                if isinstance(a, dict)]
        buffered = (observed or {}).get("buffered", 0)
        obs_metrics.record_pour(stal, int(buffered), len(arrivals))
    emit("chaos", rec)


def log_selection(round_idx: int, strategy: str,
                  sampled: Optional[list] = None,
                  excluded: Optional[list] = None,
                  target_n: Optional[int] = None,
                  dropout_posterior: Optional[float] = None,
                  **extra: Any) -> None:
    """A ``kind: selection`` record of one participant-selection decision
    (the JAX package's ``mlops.log_selection``): the clients scheduled,
    the ones benched, the cohort target and the pooled dropout posterior
    that sized it."""
    from . import metrics as obs_metrics
    rec: Dict[str, Any] = {"round_idx": int(round_idx),
                           "strategy": str(strategy)}
    if sampled is not None:
        rec["sampled"] = [int(c) for c in sampled]
    if excluded is not None:
        rec["excluded"] = [int(c) for c in excluded]
    if target_n is not None:
        rec["target_n"] = int(target_n)
    if dropout_posterior is not None:
        rec["dropout_posterior"] = float(dropout_posterior)
    rec.update(extra)
    obs_metrics.record_selection(strategy, len(sampled or ()),
                                 len(excluded or ()))
    emit("selection", rec)
