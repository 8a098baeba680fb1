"""Device-binding account registry for the agent plane (a copy of
``fedml_tpu/agents/accounts.py``: the same MACs byte for byte, down to the
``fedml-tpu/presence-mac:`` domain tag, so a mixed deployment verifies;
the database lives under the port's runs root).

Parity target: reference
``computing/scheduler/scheduler_core/account_manager.py:1-469`` — a
device binds to an account with an API key and receives a persistent
device identity + credential that later commands are checked against
(the reference stores this against the MLOps platform; local-first here
is a sqlite registry under the runs root).

Model: an account is the hash of its API key (never stored raw); a
device registration mints a random device token returned ONCE. The
registry keeps a salted hash of the token (for direct ``verify_device``
checks) plus a DERIVED mac key — presence announcements never carry the
token itself, only an HMAC proof over (device_id, status, ts, nonce)
computed from the derived key, so a broker peer watching the presence
topic cannot harvest a credential it can replay as its own enrollment
(proofs are freshness-bound; see :meth:`verify_presence`). A master
wired to the registry drops presence from unbound devices, so job
dispatch only targets devices an operator actually enrolled —
per-device revocation included, which the deployment-wide broker/bind
secrets cannot give.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import secrets
import sqlite3
import time
from typing import Any, Dict, List, Optional, Tuple


def _hash(value: str, salt: str = "") -> str:
    return hashlib.sha256((salt + value).encode()).hexdigest()


def mac_key_for(token: str) -> bytes:
    """Presence-proof key derived from the device token. The registry
    stores THIS (a server-side verifier, like any symmetric-key store),
    never the token; the agent derives it locally from its token."""
    return hashlib.sha256(b"fedml-tpu/presence-mac:"
                          + token.encode()).digest()


def _presence_body(device_id: str, status: str, ts, nonce) -> bytes:
    """ONE definition of the signed presence body — prover and verifier
    must never drift apart on field order/format."""
    return f"{device_id}|{status}|{ts}|{nonce}".encode()


def presence_proof(token: str, device_id: str, status: str, ts: float,
                   nonce: str) -> str:
    import hmac
    return hmac.new(mac_key_for(token),
                    _presence_body(device_id, status, ts, nonce),
                    hashlib.sha256).hexdigest()


def _status_body(device_id: str, request_id: str, status: str, ts,
                 nonce) -> bytes:
    """ONE definition of the signed job-status body (prover = slave,
    verifier = registry-wired master). The leading 'status:' tag domain-
    separates it from presence proofs — the two share the mac key, and a
    harvested presence proof must never verify as a job status (or vice
    versa)."""
    return f"status:{device_id}|{request_id}|{status}|{ts}|{nonce}".encode()


def status_proof(token: str, device_id: str, request_id: str, status: str,
                 ts: float, nonce: str) -> str:
    """HMAC proof a slave attaches to job-status frames: without it, any
    broker-authenticated peer could flip a bound device's live job to
    FAILED/FINISHED on the master (status poisoning)."""
    import hmac
    return hmac.new(mac_key_for(token),
                    _status_body(device_id, request_id, status, ts, nonce),
                    hashlib.sha256).hexdigest()


PRESENCE_TTL_S = 300.0


class AccountRegistry:
    """Sqlite account/device store (reference ``account_manager.py``)."""

    def __init__(self, path: Optional[str] = None):
        if path is None:
            from ..api import _runs_root
            path = os.path.join(_runs_root(), "accounts.db")
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self.path = path
        with self._conn() as c:
            c.execute("""CREATE TABLE IF NOT EXISTS accounts (
                account_id TEXT PRIMARY KEY,
                api_key_hash TEXT NOT NULL,
                api_key_salt TEXT NOT NULL DEFAULT '',
                created REAL NOT NULL)""")
            c.execute("""CREATE TABLE IF NOT EXISTS devices (
                device_id TEXT PRIMARY KEY,
                account_id TEXT NOT NULL,
                token_salt TEXT NOT NULL,
                token_hash TEXT NOT NULL,
                mac_key TEXT NOT NULL,
                registered REAL NOT NULL,
                last_seen REAL,
                revoked INTEGER DEFAULT 0,
                version TEXT DEFAULT '')""")
            # migration: a pre-mac_key devices table gains the column
            # with an empty default — those devices fail presence proofs
            # (graceful: re-enroll) instead of crashing every callback
            cols = [r[1] for r in
                    c.execute("PRAGMA table_info(devices)").fetchall()]
            if "mac_key" not in cols:
                c.execute("ALTER TABLE devices ADD COLUMN mac_key TEXT "
                          "NOT NULL DEFAULT ''")
            # migration: pre-salt accounts keep salt '' — _hash(key, '')
            # equals the legacy unsalted digest, so old rows still match
            acc_cols = [r[1] for r in
                        c.execute("PRAGMA table_info(accounts)").fetchall()]
            if "api_key_salt" not in acc_cols:
                c.execute("ALTER TABLE accounts ADD COLUMN api_key_salt "
                          "TEXT NOT NULL DEFAULT ''")

    @contextlib.contextmanager
    def _conn(self):
        conn = sqlite3.connect(self.path, timeout=10.0)
        conn.isolation_level = None
        try:
            yield conn
        finally:
            conn.close()

    # --- accounts -----------------------------------------------------------
    def login(self, api_key: str) -> str:
        """Idempotent account creation from an API key; returns the
        account id (reference ``login_with_api_key``). The key persists
        only as a SALTED hash — parity with the device-token hashing in
        the same table; an unsalted digest would let one rainbow table
        hit every deployment — and the account id derives from the
        salted digest, so no column leaks a precomputable digest.
        Idempotency without an unsalted lookup key means scanning the
        (operator-scale, a handful of rows) account list and re-hashing
        against each row's salt; legacy salt-less rows compare with
        ``_hash(key, '')`` which equals their original unsalted digest."""
        import hmac
        with self._conn() as c:
            c.execute("BEGIN IMMEDIATE")  # serialize concurrent first-logins
            try:
                rows = c.execute("SELECT account_id, api_key_hash, "
                                 "api_key_salt FROM accounts").fetchall()
                for account_id, key_hash, salt in rows:
                    if hmac.compare_digest(_hash(api_key, salt or ""),
                                           key_hash):
                        c.execute("COMMIT")
                        return account_id
                salt = secrets.token_hex(8)
                digest = _hash(api_key, salt)
                account_id = digest[:16]
                c.execute("INSERT INTO accounts (account_id, api_key_hash,"
                          " api_key_salt, created) VALUES (?, ?, ?, ?)",
                          (account_id, digest, salt, time.time()))
                c.execute("COMMIT")
            except sqlite3.Error:
                c.execute("ROLLBACK")
                raise
        return account_id

    # --- devices ------------------------------------------------------------
    def register_device(self, api_key: str,
                        device_id: Optional[str] = None
                        ) -> Tuple[str, str]:
        """Bind a device to the API key's account. Returns
        ``(device_id, device_token)`` — the token is shown exactly once;
        only its salted hash persists. An existing (or revoked) device id
        cannot be silently re-bound: re-binding would let anyone with any
        API key hijack the identity or undo a revocation — explicitly
        ``revoke`` + choose a NEW id instead.

        Generated ids are numeric (the agent plane addresses devices by
        integer id in its topics)."""
        account_id = self.login(api_key)
        device_id = device_id or str(secrets.randbelow(10 ** 9) + 10 ** 8)
        token = secrets.token_hex(24)
        salt = secrets.token_hex(8)
        with self._conn() as c:
            c.execute("BEGIN IMMEDIATE")
            try:
                row = c.execute("SELECT 1 FROM devices WHERE device_id=?",
                                (device_id,)).fetchone()
                if row is not None:
                    c.execute("ROLLBACK")
                    raise ValueError(
                        f"device {device_id!r} is already registered "
                        "(revoked identities stay dead; enroll a new id)")
                # named columns: a migrated (pre-mac_key) table has the
                # new column LAST, so positional inserts would scramble
                c.execute("INSERT INTO devices (device_id, account_id, "
                          "token_salt, token_hash, mac_key, registered, "
                          "last_seen, revoked, version) "
                          "VALUES (?, ?, ?, ?, ?, ?, NULL, 0, '')",
                          (device_id, account_id, salt,
                           _hash(token, salt),
                           mac_key_for(token).hex(), time.time()))
                c.execute("COMMIT")
            except sqlite3.Error:
                c.execute("ROLLBACK")
                raise
        return device_id, token

    def verify_device(self, device_id: str, token: str) -> bool:
        """Constant-time credential check; touches last_seen on success."""
        import hmac
        with self._conn() as c:
            row = c.execute(
                "SELECT token_salt, token_hash, revoked FROM devices "
                "WHERE device_id=?", (str(device_id),)).fetchone()
            if row is None or int(row[2]):
                return False
            ok = hmac.compare_digest(_hash(str(token), row[0]), row[1])
            if ok:
                c.execute("UPDATE devices SET last_seen=? "
                          "WHERE device_id=?", (time.time(),
                                                str(device_id)))
            return ok

    def verify_presence(self, device_id: str, status: str, ts, nonce,
                        proof, check_freshness: bool = True) -> bool:
        """Verify a presence HMAC proof (the token itself never rides the
        topic). ``check_freshness=False`` is for LAST-WILL payloads: the
        broker fires them at crash time with the proof computed at
        connect time, so their ts is legitimately stale — the only thing
        a replayed OFFLINE can do is re-mark a dead device dead."""
        import hmac
        try:
            ts_f = float(ts)
        except (TypeError, ValueError):
            return False
        if check_freshness and abs(time.time() - ts_f) > PRESENCE_TTL_S:
            return False
        with self._conn() as c:
            row = c.execute(
                "SELECT mac_key, revoked FROM devices WHERE device_id=?",
                (str(device_id),)).fetchone()
            if row is None or int(row[1]) or not row[0]:
                return False  # unknown, revoked, or pre-migration row
            want = hmac.new(bytes.fromhex(row[0]),
                            _presence_body(str(device_id), str(status),
                                           ts, nonce),
                            hashlib.sha256).hexdigest()
            ok = hmac.compare_digest(str(proof), want)
            if ok:
                c.execute("UPDATE devices SET last_seen=? "
                          "WHERE device_id=?", (time.time(),
                                                str(device_id)))
            return ok

    def verify_status(self, device_id: str, request_id: str, status: str,
                      ts, nonce, proof) -> bool:
        """Verify a job-status HMAC proof (freshness-bound like live
        presence; statuses are minted at event time, so a stale ts means
        replay or broken clocks either way)."""
        import hmac
        try:
            ts_f = float(ts)
        except (TypeError, ValueError):
            return False
        if abs(time.time() - ts_f) > PRESENCE_TTL_S:
            return False
        with self._conn() as c:
            row = c.execute(
                "SELECT mac_key, revoked FROM devices WHERE device_id=?",
                (str(device_id),)).fetchone()
            if row is None or int(row[1]) or not row[0]:
                return False  # unknown, revoked, or pre-migration row
            want = hmac.new(bytes.fromhex(row[0]),
                            _status_body(str(device_id), str(request_id),
                                         str(status), ts, nonce),
                            hashlib.sha256).hexdigest()
            # deliberately NO last_seen touch here: the master's replay
            # (nonce) check runs AFTER this verification, so a replayed
            # frame would otherwise keep refreshing liveness for a dead
            # device — presence proofs remain the only liveness signal
            return hmac.compare_digest(str(proof), want)

    def revoke_device(self, device_id: str) -> bool:
        with self._conn() as c:
            cur = c.execute("UPDATE devices SET revoked=1 "
                            "WHERE device_id=?", (str(device_id),))
            return cur.rowcount > 0

    def record_version(self, device_id: str, version: str) -> None:
        with self._conn() as c:
            c.execute("UPDATE devices SET version=? WHERE device_id=?",
                      (str(version), str(device_id)))

    def devices(self) -> List[Dict[str, Any]]:
        with self._conn() as c:
            rows = c.execute(
                "SELECT device_id, account_id, registered, last_seen, "
                "revoked, version FROM devices").fetchall()
        return [{"device_id": d, "account_id": a, "registered": r,
                 "last_seen": ls, "revoked": bool(rv), "version": v}
                for d, a, r, ls, rv, v in rows]
