"""Black-box flight recorder + stall watchdog (counterpart of
``fedml_tpu/core/obs/flight.py``; health records go through :mod:`.sink`,
and a dump is written only to a path the caller names).

An aircraft flight recorder answers the only question that matters after
a crash: *what were the last moments like?* The serving engine has the
same post-mortem problem — a wedged decode queue, a NaN'd logits step, a
SIGTERM from the platform — and the run JSONL only carries what was
*flushed* before the process died. This module keeps the answer resident:

* :class:`FlightRecorder` — a bounded ring buffer of the last N
  request-lifecycle and engine-step records (a ``deque`` of dicts; an
  append is O(1) and never blocks the decode loop), dumped as
  schema-valid ``kind: flight`` JSONL on demand, on unhandled engine
  crash, or on SIGTERM (:func:`install_signal_dump`).
* :class:`Watchdog` — a daemon thread that trips when the component it
  watches reports no progress for T seconds while it has live work
  (``occupancy > 0``), or when the component flags a poisoned step
  (NaN/inf decode logits). A trip records the
  ``obs_watchdog_trips_total`` counter, emits a ``kind: health`` record
  through the obs sink, and dumps the ring — so a wedged engine is
  diagnosable from the artifact alone.

Every dumped line validates against :mod:`.schema` (``kind: flight``),
so the same replay tooling that checks run logs checks black boxes.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from . import metrics as obs_metrics

logger = logging.getLogger(__name__)


class FlightRecorder:
    """Bounded ring of the last ``capacity`` event records.

    ``note(event, **data)`` is the hot-path API: one dict build and one
    deque append under a lock (the deque's maxlen does the eviction).
    ``dump(path)`` writes the ring oldest-first as JSONL where every
    line is a full schema-valid record (envelope included) — the file
    stands alone, no run log needed to parse it.
    """

    def __init__(self, component: str, capacity: int = 256):
        self.component = str(component)
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        self._ring: "collections.deque[Dict[str, Any]]" = collections.deque(
            maxlen=self.capacity)
        self._seq = 0
        self._dumped_paths: List[str] = []
        self._dump_counts: Dict[str, int] = {}

    def note(self, event: str, **data: Any) -> None:
        """Record one lifecycle/step event. Values must be JSON-encodable
        (the dump serializes verbatim); keep them scalars."""
        with self._lock:
            self._ring.append({"seq": self._seq, "ts": time.time(),
                               "event": str(event),
                               **({"data": data} if data else {})})
            self._seq += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def records(self) -> List[Dict[str, Any]]:
        """The ring as full schema-valid ``kind: flight`` records."""
        from . import sink
        run_id = sink.run_id()
        out = []
        for ev in self.snapshot():
            rec = {"kind": "flight", "ts": ev["ts"], "run_id": run_id,
                   "component": self.component, "seq": ev["seq"],
                   "event": ev["event"]}
            if "data" in ev:
                rec["data"] = ev["data"]
            out.append(rec)
        return out

    def dump(self, path: Optional[str] = None,
             reason: str = "manual") -> Optional[str]:
        """Write the ring to ``path``. Returns the path written, or None
        when the ring is empty or no path was given (the port writes
        nothing outside a path its caller chose). Never raises — the dump
        runs from crash handlers.

        Repeat dumps to the same nominal path get a monotonic ``.N``
        suffix: a second watchdog trip (or a reset after a trip) in one
        process must never overwrite the first episode's post-mortem."""
        try:
            recs = self.records()
            if not recs or path is None:
                return None
            root, ext = os.path.splitext(path)
            # reserve the slot atomically: worker loop (reset dump) and
            # watchdog thread (trip dump) can dump the SAME recorder
            # concurrently — racing the count/probe would hand both the
            # same target (and the same tmp name) and lose one episode
            with self._lock:
                n = self._dump_counts.get(path, 0)
                actual = path if n == 0 else f"{root}.{n}{ext}"
                # a recorder rebuilt mid-process restarts its count at
                # 0 — probe the disk so it still never clobbers
                while os.path.exists(actual):
                    n += 1
                    actual = f"{root}.{n}{ext}"
                self._dump_counts[path] = n + 1
            path = actual
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            tmp = f"{path}.{os.getpid()}.{n}.tmp"
            with open(tmp, "w") as f:
                for rec in recs:
                    f.write(json.dumps(rec) + "\n")
            os.replace(tmp, path)
            self._dumped_paths.append(path)
            logger.warning("flight recorder: dumped %d records to %s "
                           "(reason=%s)", len(recs), path, reason)
            return path
        except Exception:  # pragma: no cover — crash path must not raise
            logger.exception("flight recorder dump failed")
            return None


_signal_state: Dict[str, Any] = {"installed": False, "recorders": []}


def install_signal_dump(recorder: FlightRecorder,
                        path: Optional[str] = None) -> bool:
    """Dump ``recorder`` on SIGTERM (the platform's shutdown signal),
    then re-raise the default action so the process still dies. Only the
    main thread may install signal handlers — callers on worker threads
    get False and should rely on the crash/watchdog dumps instead.
    Multiple recorders chain onto one handler."""
    entry = (recorder, path)
    if _signal_state["installed"]:
        # a False return must mean NOT registered — only queue the
        # recorder once a handler exists (or below, once one installs)
        if entry not in _signal_state["recorders"]:
            _signal_state["recorders"].append(entry)
        return True
    if threading.current_thread() is not threading.main_thread():
        return False
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):  # pragma: no cover — signal path
            for rec, p in _signal_state["recorders"]:
                rec.dump(p, reason="sigterm")
            if callable(prev):
                prev(signum, frame)
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _on_term)
        _signal_state["installed"] = True
        _signal_state["recorders"].append(entry)
        return True
    except (ValueError, OSError):  # not main thread / restricted env
        return False


class Watchdog:
    """Stall + poisoned-step detector for one component.

    ``probe`` is called every ``interval``: it returns a dict with
    ``occupancy`` (live work count), ``last_progress_ts`` (wall time of
    the last forward step), and optionally ``poisoned`` (truthy = NaN or
    inf observed in the compute path). The watchdog trips when

    * ``occupancy > 0`` and ``now - last_progress_ts > stall_s`` — work
      exists but nothing has moved (a wedged queue), or
    * ``poisoned`` is truthy — the step still "progresses" but emits
      garbage.

    A trip fires once per episode (re-arming when progress resumes):
    bumps ``obs_watchdog_trips_total``, emits a ``kind: health`` record,
    dumps the flight recorder, and calls ``on_trip`` if given.
    """

    def __init__(self, component: str, probe: Callable[[], Dict[str, Any]],
                 recorder: Optional[FlightRecorder] = None,
                 stall_s: float = 30.0, dump_path: Optional[str] = None,
                 on_trip: Optional[Callable[[str], None]] = None):
        self.component = str(component)
        self.probe = probe
        self.recorder = recorder
        self.stall_s = float(stall_s)
        self.dump_path = dump_path
        self.on_trip = on_trip
        self.trips = 0
        self.last_trip_reason: Optional[str] = None
        self._tripped = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Watchdog":
        if self.stall_s <= 0 or self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"watchdog-{self.component}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # one sweep, separated from the loop so tests (and manual health
    # checks) can drive the exact trip logic without waiting on a thread
    def check(self, now: Optional[float] = None) -> Optional[str]:
        """Evaluate the trip conditions once; returns the trip reason if
        this call tripped, else None."""
        try:
            state = self.probe() or {}
        except Exception:  # the probe must never kill the watchdog
            logger.exception("watchdog probe failed")
            return None
        now = time.time() if now is None else float(now)
        reason = None
        if state.get("poisoned"):
            reason = "nan_logits"
        else:
            occ = int(state.get("occupancy", 0) or 0)
            last = float(state.get("last_progress_ts", now) or now)
            if occ > 0 and now - last > self.stall_s:
                reason = "stalled"
            elif occ == 0 or now - last <= self.stall_s:
                self._tripped = False  # progress resumed: re-arm
        if reason is None or self._tripped:
            return None
        self._tripped = True
        self._trip(reason, state)
        return reason

    def _trip(self, reason: str, state: Dict[str, Any]) -> None:
        self.last_trip_reason = reason
        logger.error("watchdog[%s] TRIP: %s (state=%s)", self.component,
                     reason, state)
        obs_metrics.record_watchdog_trip(self.component, reason)
        from . import sink
        sink.emit("health", {"component": self.component, "status": reason,
                             "detail": {
                                 k: v for k, v in state.items()
                                 if isinstance(v, (int, float, str, bool))}})
        if self.recorder is not None:
            self.recorder.note("watchdog_trip", reason=reason)
            self.recorder.dump(self.dump_path, reason=reason)
        # the counter moves LAST: a watcher polling `trips` may rely on
        # the dump/health artifacts already existing when it advances
        self.trips += 1
        if self.on_trip is not None:
            try:
                self.on_trip(reason)
            except Exception:
                logger.exception("watchdog on_trip callback failed")

    def _loop(self) -> None:
        interval = max(min(self.stall_s / 4.0, 5.0), 0.05)
        while not self._stop.wait(interval):
            self.check()
