"""Persistent device registry — the fleet's durable memory.

Parity target: Bonawitz et al. (MLSys'19, §4) keep a *device registry*
behind selection — the server knows every device that ever completed the
handshake, not just the ones currently connected — and run many
concurrent FL tasks against that one population. This module is the
sqlite half of that design (the pacing/claiming logic lives in
:mod:`.plane`), riding the ``ResourceDB`` idiom from
``fedml_tpu/api/scheduler.py``: one file per deployment, short-lived
connections, explicit ``BEGIN IMMEDIATE`` around every check-then-write
so concurrent task servers (separate *processes* sharing the file) stay
serialized without a daemon.

Four tables:

* ``devices`` — one row per device ever registered: handshake
  eligibility (charging/idle/unmetered analogues), first/last-heard
  timestamps, and a registration counter. :meth:`register` is an UPSERT:
  re-registering under the same id refreshes the eligibility and
  ``last_heard`` **in place** — never a duplicate row, never a reset of
  the participation history.
* ``participation`` — append-only (task, device, round, ts) records; the
  trailing-window fairness cap reads these.
* ``claims`` — the *live* round assignments; ``device_id`` is the
  primary key, so "a device serves at most one task per round" is a
  uniqueness constraint, not a convention.
* ``plane_state`` — npz-serialized control-plane snapshots (stats
  store, pacer posture, round cursor) keyed by name, so a restarted
  server resumes the learned fleet posture instead of re-learning it.

Every mutating method takes an optional ``now`` timestamp; tests and the
bench drive a logical clock through it, production callers leave the
default wall clock.
"""

from __future__ import annotations

import contextlib
import io
import logging
import os
import sqlite3
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# the handshake eligibility analogues a device row carries (mirrors
# core/selection/cohort.ELIGIBILITY_KEYS; duplicated as column names)
_ELIG_COLS = ("charging", "idle", "unmetered")

# sqlite IN(...) parameter batches stay well under SQLITE_MAX_VARIABLE_NUMBER
_IN_CHUNK = 512


def _now(now: Optional[float]) -> float:
    return time.time() if now is None else float(now)


class DeviceRegistry:
    """Sqlite-backed fleet registry: devices, participation history,
    live per-round claims, and checkpointed control-plane state."""

    def __init__(self, path: str):
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self.path = path
        with self._conn() as c:
            c.execute("""CREATE TABLE IF NOT EXISTS devices (
                device_id INTEGER PRIMARY KEY,
                os TEXT DEFAULT '?',
                engine TEXT DEFAULT '?',
                charging INTEGER DEFAULT 1,
                idle INTEGER DEFAULT 1,
                unmetered INTEGER DEFAULT 1,
                first_seen REAL NOT NULL,
                last_heard REAL NOT NULL,
                registrations INTEGER DEFAULT 1)""")
            c.execute("""CREATE TABLE IF NOT EXISTS participation (
                task_id TEXT NOT NULL,
                device_id INTEGER NOT NULL,
                round INTEGER NOT NULL,
                ts REAL NOT NULL)""")
            c.execute("""CREATE INDEX IF NOT EXISTS idx_part_device
                ON participation(device_id, ts)""")
            c.execute("""CREATE INDEX IF NOT EXISTS idx_part_round
                ON participation(device_id, round)""")
            c.execute("""CREATE TABLE IF NOT EXISTS claims (
                device_id INTEGER PRIMARY KEY,
                task_id TEXT NOT NULL,
                round INTEGER NOT NULL,
                ts REAL NOT NULL)""")
            c.execute("""CREATE TABLE IF NOT EXISTS plane_state (
                key TEXT PRIMARY KEY,
                blob BLOB NOT NULL,
                ts REAL NOT NULL)""")

    @contextlib.contextmanager
    def _conn(self):
        conn = sqlite3.connect(self.path, timeout=10.0)
        conn.isolation_level = None  # autocommit; we use explicit BEGIN
        try:
            yield conn
        finally:
            conn.close()

    # --- device table -------------------------------------------------------
    def register(self, device_id: int, meta: Optional[dict] = None,
                 now: Optional[float] = None) -> None:
        """Idempotent handshake record: first registration inserts the
        row, every later one refreshes eligibility + ``last_heard`` in
        place (``first_seen``, participation history, and the claim
        table are untouched — a flapping device never looks new)."""
        meta = meta or {}
        ts = _now(now)
        vals = (int(device_id), str(meta.get("os", "?")),
                str(meta.get("engine", "?")),
                int(bool(meta.get("charging", True))),
                int(bool(meta.get("idle", True))),
                int(bool(meta.get("unmetered", True))), ts, ts)
        with self._conn() as c:
            c.execute(
                "INSERT INTO devices (device_id, os, engine, charging, "
                "idle, unmetered, first_seen, last_heard) "
                "VALUES (?, ?, ?, ?, ?, ?, ?, ?) "
                "ON CONFLICT(device_id) DO UPDATE SET "
                "os=excluded.os, engine=excluded.engine, "
                "charging=excluded.charging, idle=excluded.idle, "
                "unmetered=excluded.unmetered, "
                "last_heard=excluded.last_heard, "
                "registrations=registrations+1", vals)

    def register_many(self, device_ids: Sequence[int],
                      metas: Optional[Sequence[dict]] = None,
                      now: Optional[float] = None) -> None:
        """Bulk :meth:`register` over one connection — fleet imports and
        the 100k-device bench; same UPSERT semantics per row."""
        ts = _now(now)
        metas = metas if metas is not None else [{}] * len(device_ids)
        rows = [(int(d), str(m.get("os", "?")), str(m.get("engine", "?")),
                 int(bool(m.get("charging", True))),
                 int(bool(m.get("idle", True))),
                 int(bool(m.get("unmetered", True))), ts, ts)
                for d, m in zip(device_ids, metas)]
        with self._conn() as c:
            c.execute("BEGIN IMMEDIATE")
            try:
                c.executemany(
                    "INSERT INTO devices (device_id, os, engine, charging, "
                    "idle, unmetered, first_seen, last_heard) "
                    "VALUES (?, ?, ?, ?, ?, ?, ?, ?) "
                    "ON CONFLICT(device_id) DO UPDATE SET "
                    "os=excluded.os, engine=excluded.engine, "
                    "charging=excluded.charging, idle=excluded.idle, "
                    "unmetered=excluded.unmetered, "
                    "last_heard=excluded.last_heard, "
                    "registrations=registrations+1", rows)
                c.execute("COMMIT")
            except sqlite3.Error:
                c.execute("ROLLBACK")
                raise

    def touch(self, device_ids: Sequence[int],
              now: Optional[float] = None) -> None:
        """Refresh ``last_heard`` (e.g. on a model upload)."""
        ts = _now(now)
        ids = [int(d) for d in device_ids]
        with self._conn() as c:
            c.executemany("UPDATE devices SET last_heard=? WHERE device_id=?",
                          [(ts, d) for d in ids])

    def device(self, device_id: int) -> Optional[dict]:
        with self._conn() as c:
            row = c.execute(
                "SELECT device_id, os, engine, charging, idle, unmetered, "
                "first_seen, last_heard, registrations FROM devices "
                "WHERE device_id=?", (int(device_id),)).fetchone()
        if row is None:
            return None
        return {"device_id": int(row[0]), "os": row[1], "engine": row[2],
                "charging": bool(row[3]), "idle": bool(row[4]),
                "unmetered": bool(row[5]), "first_seen": float(row[6]),
                "last_heard": float(row[7]), "registrations": int(row[8])}

    def device_count(self) -> int:
        with self._conn() as c:
            return int(c.execute("SELECT COUNT(*) FROM devices")
                       .fetchone()[0])

    def known_ids(self) -> np.ndarray:
        with self._conn() as c:
            rows = c.execute(
                "SELECT device_id FROM devices ORDER BY device_id"
            ).fetchall()
        return np.asarray([r[0] for r in rows], np.int64)

    def iter_id_chunks(self, chunk: int = 8192) -> Iterator[np.ndarray]:
        """Ascending device-id pages of ≤ ``chunk`` — the streaming
        cohort assembler's candidate source; the population is never
        materialized in one array."""
        chunk = max(int(chunk), 1)
        last = -1
        while True:
            with self._conn() as c:
                rows = c.execute(
                    "SELECT device_id FROM devices WHERE device_id > ? "
                    "ORDER BY device_id LIMIT ?", (last, chunk)).fetchall()
            if not rows:
                return
            ids = np.asarray([r[0] for r in rows], np.int64)
            last = int(ids[-1])
            yield ids

    def eligibility_for(self, ids: Sequence[int]) -> List[dict]:
        """Handshake metadata dicts for ``ids`` (unknown ids get the
        all-True default, matching the silent-device convention)."""
        ids = [int(d) for d in ids]
        found: Dict[int, dict] = {}
        with self._conn() as c:
            for lo in range(0, len(ids), _IN_CHUNK):
                batch = ids[lo:lo + _IN_CHUNK]
                q = ",".join("?" * len(batch))
                for row in c.execute(
                        f"SELECT device_id, charging, idle, unmetered "
                        f"FROM devices WHERE device_id IN ({q})", batch):
                    found[int(row[0])] = {"charging": bool(row[1]),
                                          "idle": bool(row[2]),
                                          "unmetered": bool(row[3])}
        default = {k: True for k in _ELIG_COLS}
        return [found.get(d, default) for d in ids]

    # --- fairness: participation history + live claims ----------------------
    def participation_counts(self, ids: Sequence[int], window_s: float,
                             now: Optional[float] = None) -> np.ndarray:
        """[len(ids)] rounds each device served (any task) inside the
        trailing ``window_s`` — the fairness cap's evidence."""
        ids = [int(d) for d in ids]
        since = _now(now) - float(window_s)
        counts: Dict[int, int] = {}
        with self._conn() as c:
            for lo in range(0, len(ids), _IN_CHUNK):
                batch = ids[lo:lo + _IN_CHUNK]
                q = ",".join("?" * len(batch))
                for did, n in c.execute(
                        f"SELECT device_id, COUNT(*) FROM participation "
                        f"WHERE ts >= ? AND device_id IN ({q}) "
                        f"GROUP BY device_id", [since] + batch):
                    counts[int(did)] = int(n)
        return np.asarray([counts.get(d, 0) for d in ids], np.int64)

    def active_claims(self) -> Dict[int, str]:
        with self._conn() as c:
            rows = c.execute(
                "SELECT device_id, task_id FROM claims").fetchall()
        return {int(d): str(t) for d, t in rows}

    def claim(self, task_id: str, ids: Sequence[int], round_idx: int,
              cap: int = 0, window_s: float = 3600.0,
              now: Optional[float] = None) -> Tuple[List[int], int, int]:
        """Atomically claim ``ids`` for one round of ``task_id``.

        Returns ``(granted, denied_busy, denied_cap)`` — assembly order
        preserved. A device already claimed by ANOTHER task is busy
        (one task per round per device: the ``claims`` primary key);
        one at/over ``cap`` participations in the trailing ``window_s``
        is capped (0 = uncapped). The check-then-insert runs under
        ``BEGIN IMMEDIATE`` so concurrent task servers sharing the file
        cannot double-claim."""
        ids = [int(d) for d in ids]
        ts = _now(now)
        since = ts - float(window_s)
        granted: List[int] = []
        denied_busy = denied_cap = 0
        with self._conn() as c:
            c.execute("BEGIN IMMEDIATE")  # serialize check+insert
            try:
                held = {int(d): str(t) for d, t in c.execute(
                    "SELECT device_id, task_id FROM claims")}
                if cap and ids:
                    counts: Dict[int, int] = {}
                    for lo in range(0, len(ids), _IN_CHUNK):
                        batch = ids[lo:lo + _IN_CHUNK]
                        q = ",".join("?" * len(batch))
                        for did, n in c.execute(
                                f"SELECT device_id, COUNT(*) "
                                f"FROM participation WHERE ts >= ? "
                                f"AND device_id IN ({q}) "
                                f"GROUP BY device_id", [since] + batch):
                            counts[int(did)] = int(n)
                else:
                    counts = {}
                for d in ids:
                    if d in held:
                        if held[d] != str(task_id):
                            denied_busy += 1
                        # re-claim by the SAME task (retry) is idempotent
                        else:
                            granted.append(d)
                        continue
                    if cap and counts.get(d, 0) >= int(cap):
                        denied_cap += 1
                        continue
                    c.execute("INSERT INTO claims VALUES (?, ?, ?, ?)",
                              (d, str(task_id), int(round_idx), ts))
                    held[d] = str(task_id)
                    granted.append(d)
                c.execute("COMMIT")
            except sqlite3.Error:
                c.execute("ROLLBACK")
                raise
        return granted, denied_busy, denied_cap

    def release(self, task_id: str, round_idx: int,
                participated: Sequence[int],
                now: Optional[float] = None) -> None:
        """Close ``task_id``'s round: drop its claims, append a
        participation record per device that actually served."""
        ts = _now(now)
        with self._conn() as c:
            c.execute("BEGIN IMMEDIATE")
            try:
                c.executemany(
                    "INSERT INTO participation VALUES (?, ?, ?, ?)",
                    [(str(task_id), int(d), int(round_idx), ts)
                     for d in participated])
                c.execute("DELETE FROM claims WHERE task_id=?",
                          (str(task_id),))
                c.execute("COMMIT")
            except sqlite3.Error:
                c.execute("ROLLBACK")
                raise

    def prune_participation(self, keep_window_s: float,
                            now: Optional[float] = None) -> int:
        """Drop participation rows older than the fairness window (the
        cap never reads them again); returns rows removed."""
        cutoff = _now(now) - float(keep_window_s)
        with self._conn() as c:
            cur = c.execute("DELETE FROM participation WHERE ts < ?",
                            (cutoff,))
            return int(cur.rowcount)

    def audit(self, cap: int = 0,
              window_s: float = 3600.0) -> Dict[str, int]:
        """Fairness post-mortem over the FULL participation history:
        ``overlap`` counts (device, round) pairs served by more than one
        task; ``cap_violations`` counts devices whose sliding
        ``window_s`` participation ever exceeded ``cap`` (0 skips the
        check). The bench and the acceptance tests pin both at zero."""
        with self._conn() as c:
            overlap = int(c.execute(
                "SELECT COUNT(*) FROM (SELECT device_id, round "
                "FROM participation GROUP BY device_id, round "
                "HAVING COUNT(DISTINCT task_id) > 1)").fetchone()[0])
            cap_violations = 0
            if cap:
                rows = c.execute(
                    "SELECT device_id, ts FROM participation "
                    "ORDER BY device_id, ts").fetchall()
                i = 0
                while i < len(rows):
                    j = i
                    did = rows[i][0]
                    while j < len(rows) and rows[j][0] == did:
                        j += 1
                    ts = [r[1] for r in rows[i:j]]
                    lo = 0
                    worst = 0
                    for hi in range(len(ts)):
                        while ts[hi] - ts[lo] >= float(window_s):
                            lo += 1
                        worst = max(worst, hi - lo + 1)
                    if worst > int(cap):
                        cap_violations += 1
                    i = j
        return {"overlap": overlap, "cap_violations": cap_violations}

    # --- checkpointed control-plane state -----------------------------------
    def save_state(self, key: str, arrays: Dict[str, np.ndarray],
                   now: Optional[float] = None) -> None:
        """Persist one named control-plane snapshot (stats store columns,
        pacer posture, round cursor) as an npz blob — the shapes travel
        with the data, so the sparse store's compacted columns fit."""
        buf = io.BytesIO()
        np.savez_compressed(
            buf, **{k: np.asarray(v) for k, v in arrays.items()})
        with self._conn() as c:
            c.execute("INSERT OR REPLACE INTO plane_state VALUES (?, ?, ?)",
                      (str(key), buf.getvalue(), _now(now)))

    def load_state(self, key: str) -> Optional[Dict[str, np.ndarray]]:
        with self._conn() as c:
            row = c.execute("SELECT blob FROM plane_state WHERE key=?",
                            (str(key),)).fetchone()
        if row is None:
            return None
        with np.load(io.BytesIO(row[0]), allow_pickle=False) as z:
            return {k: z[k].copy() for k in z.files}

    def state_keys(self) -> List[str]:
        with self._conn() as c:
            rows = c.execute(
                "SELECT key FROM plane_state ORDER BY key").fetchall()
        return [str(r[0]) for r in rows]
