"""Resource allocation store + matcher + job monitor (a copy of
``fedml_tpu/api/scheduler.py``; a restart relaunches through the port's
api, and the store lives under the port's runs root).

Parity target: the reference scheduler core —
``computing/scheduler/scheduler_core/compute_gpu_db.py:1-333`` (sqlite
device/GPU allocation tables), ``scheduler_matcher.py:1-124`` (match a
job's resource request against available devices), and
``comm_utils/job_monitor.py:338,450`` (periodic monitor that detects
dead runs/endpoints and restarts them).

Local-first redesign: one sqlite file under the runs root holds the
device table and live allocations;
:func:`fedml_tpu_torch.api.launch_job` consults the matcher when a job
yaml carries a ``computing:`` section (``device_slots: N``), and releases
the allocation when the run reaches a terminal state. The
:class:`JobMonitor` generalizes the serving replica-set health check to
training runs: a run whose process died WITHOUT writing an exit record
(SIGKILL, OOM, host crash) is a crash — distinct from a graceful nonzero
exit — and, if the job opted in (``restart: true``), it is relaunched on
the device it was launched with. Restart lineage and counts are
persisted in the run metas, so the cap survives monitor restarts.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sqlite3
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


class ResourceDB:
    """Sqlite-backed device + allocation store (reference
    ``compute_gpu_db.py``: ``ComputeGpuDatabase`` over sqlite). One file
    per deployment; safe for concurrent processes (sqlite handles the
    locking)."""

    def __init__(self, path: Optional[str] = None):
        if path is None:
            from . import _runs_root
            path = os.path.join(_runs_root(), "resources.db")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.path = path
        with self._conn() as c:
            c.execute("""CREATE TABLE IF NOT EXISTS devices (
                device_id TEXT PRIMARY KEY,
                total_slots INTEGER NOT NULL,
                meta TEXT DEFAULT '{}')""")
            c.execute("""CREATE TABLE IF NOT EXISTS allocations (
                run_id TEXT PRIMARY KEY,
                device_id TEXT NOT NULL,
                slots INTEGER NOT NULL,
                ts REAL NOT NULL)""")

    @contextlib.contextmanager
    def _conn(self):
        conn = sqlite3.connect(self.path, timeout=10.0)
        conn.isolation_level = None  # autocommit; we use explicit BEGIN
        try:
            yield conn
        finally:
            conn.close()

    @staticmethod
    def _free_map(c) -> Dict[str, int]:
        """device_id -> free slots, in ONE query on an open connection."""
        rows = c.execute(
            "SELECT d.device_id, "
            "       d.total_slots - COALESCE(SUM(a.slots), 0) "
            "FROM devices d LEFT JOIN allocations a "
            "     ON a.device_id = d.device_id "
            "GROUP BY d.device_id, d.total_slots").fetchall()
        return {d: int(f) for d, f in rows}

    @staticmethod
    def _match_in(free: Dict[str, int], slots: int) -> Optional[str]:
        """Best-fit-by-headroom (reference ``scheduler_matcher.py``:
        order candidates by available capacity): the device with the
        most free slots that still fits; None = no capacity."""
        best, best_free = None, -1
        for dev, f in free.items():
            if f >= int(slots) and f > best_free:
                best, best_free = dev, f
        return best

    # --- device table -------------------------------------------------------
    def register_device(self, device_id: str, total_slots: int,
                        meta: Optional[dict] = None) -> None:
        with self._conn() as c:
            c.execute("INSERT OR REPLACE INTO devices VALUES (?, ?, ?)",
                      (device_id, int(total_slots),
                       json.dumps(meta or {})))

    def devices(self) -> List[Dict[str, Any]]:
        with self._conn() as c:
            rows = c.execute(
                "SELECT device_id, total_slots, meta FROM devices"
            ).fetchall()
            free = self._free_map(c)
        return [{"device_id": d, "total_slots": s,
                 "meta": json.loads(m), "free_slots": free.get(d, 0)}
                for d, s, m in rows]

    def free_slots(self, device_id: str) -> int:
        with self._conn() as c:
            return self._free_map(c).get(device_id, 0)

    def match(self, slots: int) -> Optional[str]:
        with self._conn() as c:
            return self._match_in(self._free_map(c), slots)

    # --- allocations --------------------------------------------------------
    def allocate(self, run_id: str, slots: int,
                 device_id: Optional[str] = None) -> Optional[str]:
        """Atomically claim ``slots`` on ``device_id`` (or the matcher's
        pick). Returns the device id, or None when nothing fits."""
        with self._conn() as c:
            c.execute("BEGIN IMMEDIATE")  # serialize check+insert
            try:
                free = self._free_map(c)
                target = device_id or self._match_in(free, slots)
                if target is None or free.get(target, 0) < int(slots):
                    c.execute("ROLLBACK")
                    return None
                c.execute("INSERT OR REPLACE INTO allocations "
                          "VALUES (?, ?, ?, ?)",
                          (run_id, target, int(slots), time.time()))
                c.execute("COMMIT")
                return target
            except sqlite3.Error:
                c.execute("ROLLBACK")
                raise

    def release(self, run_id: str) -> bool:
        with self._conn() as c:
            cur = c.execute("DELETE FROM allocations WHERE run_id=?",
                            (run_id,))
            return cur.rowcount > 0

    def allocations(self) -> List[Dict[str, Any]]:
        with self._conn() as c:
            rows = c.execute(
                "SELECT run_id, device_id, slots, ts FROM allocations"
            ).fetchall()
        return [{"run_id": r, "device_id": d, "slots": s, "ts": ts}
                for r, d, s, ts in rows]


_default_db: Optional[ResourceDB] = None
_db_lock = threading.Lock()


def default_db() -> ResourceDB:
    """Process-wide ResourceDB with a 'local' device auto-registered
    (slots from ``FEDML_TPU_LOCAL_SLOTS``, default 8)."""
    global _default_db
    with _db_lock:
        if _default_db is None:
            db = ResourceDB()
            if not any(d["device_id"] == "local" for d in db.devices()):
                db.register_device(
                    "local",
                    int(os.environ.get("FEDML_TPU_LOCAL_SLOTS", "8")))
            _default_db = db
        return _default_db


def _reset_default_db() -> None:  # test isolation (runs root changes)
    global _default_db
    with _db_lock:
        _default_db = None


def _pid_dead(pid: int) -> bool:
    """True when the process is gone OR a zombie — ``kill(pid, 0)``
    succeeds on zombies (a dead child nobody reaped), but a zombie does
    no work and must count as dead. Falls back to the portable signal-0
    probe where procfs is unavailable (macOS)."""
    from . import _pid_alive
    if pid <= 0:
        return True
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
        return state == "Z"
    except FileNotFoundError:
        return not _pid_alive(pid)  # no procfs entry: gone, or non-Linux
    except (OSError, IndexError):
        return not _pid_alive(pid)


class JobMonitor:
    """Periodic run supervisor (reference ``job_monitor.py``
    ``monitor_slave_run_process_status`` :338 + endpoint restarts :450).

    Crash detection is exit-record based, NOT pid based: a terminal run
    with no ``exit_code`` file died silently (SIGKILL/OOM) no matter who
    noticed first — ``run_status`` may already have reconciled the
    registry entry to FAILED before this scan. Restart bookkeeping
    (``restart_of``, ``restart_index``, ``monitor_handled``) lives in
    the run metas, so the ``max_restarts`` cap binds across monitor
    restarts and multiple monitors."""

    def __init__(self, interval_s: float = 1.0, max_restarts: int = 3):
        self.interval_s = float(interval_s)
        self.max_restarts = int(max_restarts)
        self.restarted: Dict[str, str] = {}   # dead run -> replacement
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "JobMonitor":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scan_once()
            except Exception:
                logger.exception("job monitor scan failed")

    def scan_once(self) -> List[str]:
        """One scan; returns run ids newly detected as crashed."""
        from . import (STATUS_FAILED, STATUS_FINISHED, STATUS_KILLED,
                       STATUS_RUNNING, _finalize, _read_exit_code,
                       _read_meta, _release_allocation, _run_dir,
                       _write_meta, launch_job, run_list)
        acted = []
        for meta in run_list():  # run_list reconciles statuses itself
            run_id = meta.get("run_id")
            status = meta.get("status")
            rc_recorded = os.path.exists(
                os.path.join(_run_dir(run_id), "exit_code"))
            if status == STATUS_RUNNING:
                if not _pid_dead(int(meta.get("pid", -1))):
                    continue
                # the pid poll and the exit-record stat race the job's
                # shutdown: a run can write exit_code between run_list's
                # reconcile and our poll. Re-check the record NOW, before
                # forcing FAILED — a recorded rc means a normal exit and
                # is authoritative (finalize with it instead).
                rc = _read_exit_code(run_id)
                if rc is not None:
                    _finalize(run_id, rc)   # writes terminal meta AND
                    meta = _read_meta(run_id) or meta   # releases the
                    meta["allocation_released"] = True  # allocation
                    crashed = False
                else:
                    # dead (incl. zombie) with no exit record: a silent
                    # death (SIGKILL/OOM) — finalize it ourselves
                    fresh = _read_meta(run_id) or meta
                    fresh["status"] = STATUS_FAILED
                    fresh["error"] = "process died without exit record"
                    _write_meta(fresh["run_id"], fresh)
                    meta = fresh
                    crashed = True
            elif status == STATUS_FAILED and not rc_recorded:
                # run_status (ours or any other poller's) already marked
                # the silent death — still OUR crash to handle, once.
                # pid <= 0 = the launch itself failed (nothing ever ran):
                # not a crash to restart.
                crashed = int(meta.get("pid", -1)) > 0
            elif status in (STATUS_FINISHED, STATUS_KILLED,
                            STATUS_FAILED):
                # only runs that ever CLAIMED capacity need a release, and
                # only once — _finalize/run_stop already released them, so
                # this is a belt-and-braces sweep, not a per-scan sqlite
                # DELETE for every historical run forever
                if (meta.get("device_id")
                        and not meta.get("allocation_released")):
                    _release_allocation(run_id)
                    meta["allocation_released"] = True
                    _write_meta(run_id, meta)
                continue
            else:
                continue
            if meta.get("monitor_handled"):
                continue
            meta["monitor_handled"] = True
            if not meta.get("allocation_released"):
                _release_allocation(run_id)
                meta["allocation_released"] = True
            _write_meta(run_id, meta)
            if not crashed:
                continue
            acted.append(run_id)
            logger.warning("job monitor: run %s died (pid %s)", run_id,
                           meta.get("pid"))
            if not self._wants_restart(meta):
                continue
            n = int(meta.get("restart_index", 0))
            if n >= self.max_restarts:
                logger.error("job monitor: lineage of %s exceeded "
                             "max_restarts=%d",
                             meta.get("lineage_root", run_id),
                             self.max_restarts)
                continue
            res = launch_job(meta["yaml"], device=meta.get("device"))
            if res.result_code == 0:
                root = meta.get("lineage_root", run_id)
                self.restarted[run_id] = res.run_id
                new_meta = _read_meta(res.run_id) or {}
                new_meta["restart_of"] = run_id
                new_meta["lineage_root"] = root
                new_meta["restart_index"] = n + 1
                _write_meta(res.run_id, new_meta)
                logger.warning("job monitor: restarted %s as %s "
                               "(restart %d/%d)", run_id, res.run_id,
                               n + 1, self.max_restarts)
        return acted

    @staticmethod
    def _wants_restart(meta: Dict[str, Any]) -> bool:
        yaml_file = meta.get("yaml")
        if not yaml_file or not os.path.exists(yaml_file):
            return False
        try:
            import yaml as _yaml
            spec = _yaml.safe_load(open(yaml_file)) or {}
        except Exception:
            return False
        return bool(spec.get("restart"))
