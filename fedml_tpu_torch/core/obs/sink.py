"""Where the obs planes' records go (the port's stand-in for the JAX
package's ``mlops._emit``, which this package does not port yet).

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
