"""Where the obs planes' records go: the one funnel of every record the
port writes (the JAX package's ``mlops._emit``; :mod:`..mlops` emits
through it and re-exports its ``log_round_info`` / ``log_chaos`` /
``log_selection``).

Spans, metric snapshots, round, chaos, selection, comm and health records
are dicts handed to :func:`emit`, which stamps the envelope (``kind``,
``ts``, ``run_id``) and hands the record to two destinations:

* the run's JSONL file, which ``mlops.init`` installs
  (:func:`set_file_sink`; ``enable_tracking``, ``log_file_dir``), as the
  JAX package's ``mlops.init`` does;
* a caller's callable (:func:`set_sink`), e.g. a test's list.

Neither is installed until someone asks, so library use without
``init`` writes nothing.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

_state: Dict[str, Any] = {"sink": None, "file": None, "run_id": "0"}


def set_sink(fn: Optional[Callable[[Dict[str, Any]], None]],
             run_id: Optional[str] = None) -> None:
    """Install (or, with None, remove) the caller's record sink; a
    ``run_id`` given replaces the one records carry."""
    _state["sink"] = fn
    if run_id is not None:
        _state["run_id"] = str(run_id)


def set_file_sink(fn: Optional[Callable[[Dict[str, Any]], None]],
                  run_id: Optional[str] = None) -> None:
    """Install (or, with None, remove) the run's JSONL sink (``mlops``'s
    ``JsonSink.emit``), and the run id every record carries."""
    _state["file"] = fn
    if run_id is not None:
        _state["run_id"] = str(run_id)


def run_id() -> str:
    return _state["run_id"]


def emit(kind: str, payload: Dict[str, Any]) -> None:
    """Hand one record (``kind``, ``ts``, ``run_id`` added) to the run's
    file and to the caller's sink, where installed."""
    sink, file = _state["sink"], _state["file"]
    if sink is None and file is None:
        return
    rec = dict(payload)
    rec.update({"kind": kind, "ts": time.time(), "run_id": _state["run_id"]})
    if file is not None:
        file(rec)
    if sink is not None:
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
              link: Optional[Dict[str, Any]] = None,
              arrivals: Optional[list] = None,
              serving: Optional[Dict[str, Any]] = None) -> None:
    """A ``kind: chaos`` record of the fault ledger (the JAX package's
    ``mlops.log_chaos``): what the ``FaultPlan`` injected against what the
    round observed, one link fault of the transport interceptor (``link``:
    sender, receiver, message type, copies, delay) or one injected serving
    fault (``serving``: its kind and where it landed). ``arrivals``
    carries a buffered-async pour's per-update records (client, staleness
    at aggregation, arrival time, dispatch version); they also feed the
    staleness and buffer-occupancy histograms (``metrics.record_pour``)."""
    rec: Dict[str, Any] = {}
    if round_idx is not None:
        rec["round_idx"] = int(round_idx)
    if injected is not None:
        rec["injected"] = injected
    if observed is not None:
        rec["observed"] = observed
    if link is not None:
        rec["link"] = link
    if serving is not None:
        rec["serving"] = serving
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
