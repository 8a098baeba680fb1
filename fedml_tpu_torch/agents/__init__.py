"""MLOps agent daemons over the pub/sub control plane (counterpart of
``fedml_tpu/agents``; the job-signing MACs, topics and frames are the JAX
package's, so agents of both packages share one broker).

Parity target: the reference's scheduler agents — a slave agent binds to
the platform, receives start/stop-run commands over MQTT topics, executes
jobs, and streams status back through a message center with a retry queue
(``computing/scheduler/scheduler_core/message_center.py:21,184``,
``status_center.py:18,178``, ``slave/base_slave_protocol_manager.py``).

TPU-native redesign, local-first: the transport is the repo's own stdlib
pub/sub broker (``core/distributed/communication/pubsub``, the MQTT
analogue with last-will), job execution is :mod:`fedml_tpu_torch.api`'s
run registry (subprocess + meta.json; a training config trains on the
agent's card, or on ``device``), and the daemons are threads or standalone
processes (``python -m fedml_tpu_torch.cli agent``).

Topic scheme (reference ``flclient_agent/<edge>/start_train`` shape):

- ``flclient_agent/<device>/start_train``  master -> slave: job spec
- ``flclient_agent/<device>/stop_train``   master -> slave: stop a run
- ``fl_client/mlops/status``               slave -> master: device/run status
- ``fl_client/agent/online``               slave presence; last-will posts
  the OFFLINE payload on abnormal disconnect
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from ..core.distributed.communication.pubsub import (_recv_frame,
                                                     _send_frame,
                                                     client_connect)

logger = logging.getLogger(__name__)

# device statuses (reference status_center.py DeviceStatus, reduced to the
# lifecycle a local-first deployment has)
DEVICE_IDLE = "IDLE"
DEVICE_RUNNING = "RUNNING"
DEVICE_OFFLINE = "OFFLINE"

# job statuses re-exported from the run registry plus the pre-launch one
JOB_PROVISIONING = "PROVISIONING"
JOB_RUNNING = "RUNNING"
JOB_FINISHED = "FINISHED"
JOB_FAILED = "FAILED"
JOB_KILLED = "KILLED"

TOPIC_STATUS = "fl_client/mlops/status"
TOPIC_ONLINE = "fl_client/agent/online"


# Signed commands are only honored within this window of their signing
# time, and a MAC is single-use within it — together these close the
# replay a passive broker observer could otherwise mount (capturing a
# signed stop_train and firing it later at a re-used request id).
JOB_MAC_TTL_S = 300.0

# check_job reason for an exact re-delivery of an already-honored frame —
# callers treat this one specially: the message center's at-least-once
# sender can legitimately produce byte-identical resends (same MAC), which
# must be re-announced, never reported as a failure of the live request
REASON_REPLAY = "replayed command (MAC already seen)"


def agent_secret() -> Optional[bytes]:
    """Shared bind token for job dispatch (``FEDML_TPU_AGENT_SECRET``).
    Independent of the broker secret: even a peer that can reach the
    broker cannot start jobs without it. None = no token configured —
    daemons REFUSE to start that way unless told ``insecure_open``.
    Reference counterpart: device binding through the account manager
    (``scheduler_core/account_manager.py:1-469``)."""
    s = os.environ.get("FEDML_TPU_AGENT_SECRET", "")
    return s.encode() if s else None


def _job_mac(secret: bytes, payload: dict) -> str:
    """HMAC over the canonical job command (everything except the mac
    itself), binding request id, target, yaml content, and the signing
    timestamp + nonce added by :func:`sign_job`."""
    import hashlib
    import hmac as _hmac
    body = json.dumps({k: v for k, v in sorted(payload.items())
                       if k != "auth"}, sort_keys=True,
                      separators=(",", ":"))
    return _hmac.new(secret, body.encode(), hashlib.sha256).hexdigest()


def sign_job(payload: dict, secret: Optional[bytes] = None) -> dict:
    secret = secret if secret is not None else agent_secret()
    if secret is not None:
        payload = dict(payload)
        payload["ts"] = time.time()
        payload["nonce"] = uuid.uuid4().hex
        payload["auth"] = _job_mac(secret, payload)
    return payload


def check_job(payload: dict, secret: Optional[bytes] = None,
              seen_macs: Optional[Dict[str, float]] = None) -> Optional[str]:
    """None iff the command carries a valid, fresh, never-before-seen
    MAC; otherwise a human-readable refusal reason. A bad token and a
    stale timestamp are DIFFERENT operational failures (rotate secrets
    vs fix NTP) and are reported distinctly.

    ``secret=None`` (and no env token) accepts everything — callers own
    that decision; the daemons only reach it through an explicit
    ``insecure_open``. ``seen_macs`` is the caller's replay ledger
    (mac -> first-seen time). Only a freshness window of entries ever
    needs keeping (older frames fail the ts check on their own), so
    pruning drops entries older than the TTL and, under a flood, evicts
    oldest-first down to the cap instead of scanning forever.
    """
    import hmac as _hmac
    secret = secret if secret is not None else agent_secret()
    if secret is None:
        return None  # explicit insecure-open deployment
    mac = payload.get("auth")
    if not mac or not _hmac.compare_digest(str(mac),
                                           _job_mac(secret, payload)):
        return "bad or missing bind token"
    ts = payload.get("ts")
    now = time.time()
    if not isinstance(ts, (int, float)) or abs(now - ts) > JOB_MAC_TTL_S:
        return ("stale or clock-skewed command timestamp (>%.0fs; fix "
                "NTP or re-dispatch)" % JOB_MAC_TTL_S)
    if seen_macs is not None:
        if mac in seen_macs:
            return REASON_REPLAY
        seen_macs[str(mac)] = now
        if len(seen_macs) > 4096:
            for m, t in list(seen_macs.items()):
                if now - t > JOB_MAC_TTL_S:
                    del seen_macs[m]
            while len(seen_macs) > 4096:  # flood of still-fresh MACs
                seen_macs.pop(min(seen_macs, key=seen_macs.get))
    return None


def verify_job(payload: dict, secret: Optional[bytes] = None,
               seen_macs: Optional[Dict[str, float]] = None) -> bool:
    return check_job(payload, secret, seen_macs) is None


def _topic_start(device_id: int) -> str:
    return f"flclient_agent/{device_id}/start_train"


def _topic_stop(device_id: int) -> str:
    return f"flclient_agent/{device_id}/stop_train"


def _topic_upgrade(device_id: int) -> str:
    return f"flclient_agent/{device_id}/upgrade"


class MessageCenter:
    """Broker client with a durable sender: publishes ride a queue drained
    by a sender thread with bounded retries, and sent/received records land
    in JSONL files (reference ``message_center.py`` RETRY_COUNT=3 +
    message-sent-records.log). Subscriptions dispatch to topic handlers on
    a receive thread."""

    RETRY_COUNT = 3
    RETRY_DELAY_S = 0.5

    def __init__(self, broker_host: str, broker_port: int,
                 record_dir: Optional[str] = None,
                 will_topic: Optional[str] = None,
                 will_payload=None):
        self._addr = (broker_host, int(broker_port))
        self._handlers: Dict[str, Callable[[dict], None]] = {}
        self._subs: List[str] = []
        # will_payload may be a dict or a CALLABLE returning one: the LWT
        # is re-installed on every reconnect, and a proof-carrying will
        # must be minted fresh each time (the master's nonce ledger makes
        # proofs single-use — a reused will would be dropped as replay
        # exactly when the device actually dies)
        self._will = (will_topic, will_payload)
        self._sock: Optional[socket.socket] = None
        self._sock_lock = threading.Lock()
        self._queue: List[dict] = []
        self._queue_cv = threading.Condition()
        self._in_flight = False   # sender popped an item it hasn't settled
        self._running = False
        self._record_dir = record_dir
        if record_dir:
            os.makedirs(record_dir, exist_ok=True)

    # --- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._connect()
        self._running = True
        threading.Thread(target=self._recv_loop, daemon=True).start()
        threading.Thread(target=self._send_loop, daemon=True).start()

    def stop(self, graceful: bool = True) -> None:
        self._running = False
        with self._queue_cv:
            self._queue_cv.notify_all()
        with self._sock_lock:
            if self._sock is not None:
                try:
                    if graceful:
                        _send_frame(self._sock, {"kind": "disconnect"})
                    self._sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    def _connect(self) -> None:
        sock = client_connect(self._addr[0], self._addr[1])
        for topic in self._subs:
            _send_frame(sock, {"kind": "sub", "topic": topic})
        if self._will[0] is not None:
            will = self._will[1]
            if callable(will):
                will = will()  # fresh nonce/proof per connection
            _send_frame(sock, {"kind": "lwt", "topic": self._will[0],
                               "payload": json.dumps(will)})
        self._sock = sock

    # --- pub/sub -----------------------------------------------------------
    def subscribe(self, topic: str, handler: Callable[[dict], None]) -> None:
        self._handlers[topic] = handler
        self._subs.append(topic)
        with self._sock_lock:
            if self._sock is not None:
                _send_frame(self._sock, {"kind": "sub", "topic": topic})

    def publish(self, topic: str, payload: dict) -> None:
        """Enqueue for the durable sender (returns immediately)."""
        with self._queue_cv:
            self._queue.append({"topic": topic, "payload": payload,
                                "id": uuid.uuid4().hex, "tries": 0})
            self._queue_cv.notify()

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Block until the sender has drained the queue AND settled the
        item it popped (sent or dropped) — needed before process
        replacement (OTA re-exec): the sender pops before sending, so
        queue-empty alone would let execve clobber an UPGRADED status
        that is still on its way to the socket."""
        deadline = time.time() + timeout_s
        with self._queue_cv:
            while time.time() < deadline:
                if not self._queue and not self._in_flight:
                    return True
                self._queue_cv.wait(timeout=min(
                    0.05, max(deadline - time.time(), 0.001)))
        return False

    def _record(self, name: str, entry: dict) -> None:
        if not self._record_dir:
            return
        try:
            with open(os.path.join(self._record_dir, name), "a") as f:
                f.write(json.dumps(entry) + "\n")
        except OSError:
            pass

    def _send_loop(self) -> None:
        while True:
            with self._queue_cv:
                while self._running and not self._queue:
                    self._queue_cv.wait(timeout=1.0)
                if not self._running:
                    return
                item = self._queue.pop(0)
                self._in_flight = True
            try:
                self._record("message-sent-records.log",
                             {"id": item["id"], "topic": item["topic"],
                              "ts": time.time()})
                ok = False
                while item["tries"] < self.RETRY_COUNT and not ok:
                    item["tries"] += 1
                    try:
                        with self._sock_lock:
                            if self._sock is None:
                                if not self._running:
                                    break  # stopped: don't resurrect the
                                    # socket (it would re-install the LWT
                                    # and later fire a spurious OFFLINE)
                                self._connect()
                            _send_frame(self._sock, {
                                "kind": "pub", "topic": item["topic"],
                                "payload": json.dumps(item["payload"])})
                        ok = True
                    except OSError as e:
                        logger.warning("message center: publish failed "
                                       "(try %d/%d): %s", item["tries"],
                                       self.RETRY_COUNT, e)
                        with self._sock_lock:
                            self._sock = None
                        time.sleep(self.RETRY_DELAY_S * item["tries"])
                if ok:
                    self._record("message-sent-success-records.log",
                                 {"id": item["id"], "topic": item["topic"],
                                  "ts": time.time()})
                else:
                    self._record("message-dropped-records.log",
                                 {"id": item["id"], "topic": item["topic"],
                                  "ts": time.time()})
            except Exception:  # e.g. unserializable payload: drop the
                # item, keep the sender alive for the rest of the queue
                logger.exception("message center: dropping unsendable "
                                 "message %s", item["id"])
                self._record("message-dropped-records.log",
                             {"id": item["id"], "topic": item["topic"],
                              "ts": time.time()})
            finally:
                # ALWAYS settle, even if publish raised something beyond
                # OSError (e.g. an unserializable payload) — a stuck
                # in-flight flag would make every future flush() time out
                with self._queue_cv:
                    self._in_flight = False
                    self._queue_cv.notify_all()

    def _recv_loop(self) -> None:
        backoff = 0.2
        while self._running:
            with self._sock_lock:
                sock = self._sock
            if sock is None:
                # reconnect here too: a recv-only agent (a slave waiting
                # for commands) would otherwise go permanently deaf after
                # a broker restart — _connect replays subscriptions + LWT
                try:
                    with self._sock_lock:
                        if self._sock is None:
                            self._connect()
                    backoff = 0.2
                except OSError:
                    time.sleep(backoff)
                    backoff = min(backoff * 2, 5.0)
                continue
            try:
                frame = _recv_frame(sock)
            except OSError:
                frame = None
            if frame is None:
                with self._sock_lock:
                    if self._sock is sock:  # dead socket: force reconnect
                        self._sock = None
                if self._running:
                    time.sleep(0.2)
                continue
            topic = frame.get("topic")
            try:
                payload = json.loads(frame.get("payload"))
            except (TypeError, ValueError):
                logger.warning("message center: undecodable payload on %r",
                               topic)
                continue
            self._record("message-received-records.log",
                         {"topic": topic, "ts": time.time()})
            handler = self._handlers.get(topic)
            if handler is None:
                continue
            try:
                handler(payload)
            except Exception:  # a bad handler must not kill the daemon
                logger.exception("message center: handler for %r failed",
                                 topic)


class SlaveAgent:
    """Compute-agent daemon (reference ``base_slave_protocol_manager``):
    binds to the broker, executes start-train commands through the local
    run registry, streams status transitions back, and dies loudly (the
    broker fires its last-will) on abnormal disconnect."""

    def __init__(self, device_id: int, broker_host: str, broker_port: int,
                 poll_s: float = 0.5, secret: Optional[bytes] = None,
                 insecure_open: bool = False,
                 device_token: Optional[str] = None,
                 device: Optional[str] = None):
        self.device_id = int(device_id)
        self.poll_s = poll_s
        # the torch device a training config's job runs on (None: the card)
        self.device = device
        # per-device credential from the account registry (reference
        # account_manager binding); shown in presence so a registry-wired
        # master only schedules onto enrolled devices
        self.device_token = (device_token
                             or os.environ.get("FEDML_TPU_DEVICE_TOKEN"))
        self.current_version: Optional[str] = None
        # secure by default: a daemon that executes arbitrary shell jobs
        # must not come up accepting ANY start_train published to its
        # topic — open deployment is an explicit flag, never a default
        self._secret = secret if secret is not None else agent_secret()
        if self._secret is None and not insecure_open:
            raise RuntimeError(
                "SlaveAgent: refusing to start without a bind token. Set "
                "FEDML_TPU_AGENT_SECRET (or pass secret=) so job dispatch "
                "is authenticated, or pass insecure_open=True to "
                "explicitly accept unauthenticated commands.")
        self._insecure_open = insecure_open and self._secret is None
        from ..api import _runs_root
        # the replay ledger persists across daemon restarts: an in-memory
        # ledger alone would re-accept a captured frame replayed inside
        # the freshness window right after a crash/relaunch
        self._ledger_path = os.path.join(
            _runs_root(), f"agent_{device_id}", "seen-macs.log")
        self._seen_macs: Dict[str, float] = self._load_ledger()
        # the LWT must pass the same registry gate as live presence, or a
        # bound device's crash would be silently dropped; it is a FACTORY
        # so every reconnect installs a fresh nonce/proof (the master's
        # ledger makes proofs single-use), and the master verifies
        # OFFLINE proofs without freshness (computed at connect time)
        self.center = MessageCenter(
            broker_host, broker_port,
            record_dir=os.path.join(_runs_root(), f"agent_{device_id}"),
            will_topic=TOPIC_ONLINE,
            will_payload=lambda: self._presence(DEVICE_OFFLINE))
        # request run-id -> registry run-id (for stop routing)
        self.runs: Dict[str, str] = {}
        self._seen_requests = set()
        # last status published per request — a redelivered start_train
        # re-announces THIS (a finished job must not be resurrected to
        # RUNNING by a duplicate frame)
        self._last_status: Dict[str, Dict[str, Any]] = {}
        self._watchers: Dict[str, threading.Thread] = {}

    # --- replay ledger persistence -----------------------------------------
    def _load_ledger(self) -> Dict[str, float]:
        seen: Dict[str, float] = {}
        now = time.time()
        try:
            with open(self._ledger_path) as f:
                for line in f:
                    try:
                        mac, ts = line.split()
                        if now - float(ts) <= 2 * JOB_MAC_TTL_S:
                            seen[mac] = float(ts)
                    except ValueError:
                        continue
        except OSError:
            return seen
        # compact: the file is append-only while running, so rewrite it at
        # load with only the surviving (freshness-window) entries — a
        # long-lived daemon must not accrete an unbounded ledger
        try:
            tmp = self._ledger_path + ".tmp"
            with open(tmp, "w") as f:
                for mac, ts in seen.items():
                    f.write(f"{mac} {ts}\n")
            os.replace(tmp, self._ledger_path)
        except OSError:
            pass
        return seen

    def _remember_mac(self, payload: dict) -> None:
        mac = payload.get("auth")
        if not mac:
            return
        try:
            os.makedirs(os.path.dirname(self._ledger_path), exist_ok=True)
            with open(self._ledger_path, "a") as f:
                f.write(f"{mac} {self._seen_macs.get(str(mac), time.time())}\n")
        except OSError:
            pass

    def _check(self, payload: dict) -> Optional[str]:
        reason = check_job(payload, self._secret,
                           seen_macs=self._seen_macs)
        if reason is None:
            self._remember_mac(payload)
        return reason

    def _reannounce(self, request_id: str) -> bool:
        """Re-publish the request's ACTUAL last status (the anti-
        poisoning contract for duplicates/replays: never hardcode RUNNING
        — it would resurrect a finished job — and never emit FAILED for
        a live one). True if a status was re-announced."""
        last = self._last_status.get(request_id)
        if request_id in self._seen_requests and last:
            self._status(request_id, last["status"],
                         **{k: v for k, v in last.items()
                            if k != "status"})
            return True
        return False

    def _presence(self, status: str) -> dict:
        """Presence payload. With a device token, it carries an HMAC
        PROOF over (device_id, status, ts, nonce) — never the token
        itself, which a broker peer could harvest from the shared
        topic."""
        p = {"device_id": self.device_id, "status": status}
        if self.device_token:
            from .accounts import presence_proof
            p["ts"] = time.time()
            p["nonce"] = uuid.uuid4().hex
            p["proof"] = presence_proof(self.device_token,
                                        str(self.device_id), status,
                                        p["ts"], p["nonce"])
        return p

    def start(self, presence_interval_s: float = 30.0) -> None:
        c = self.center
        c.subscribe(_topic_start(self.device_id), self._on_start)
        c.subscribe(_topic_stop(self.device_id), self._on_stop)
        c.subscribe(_topic_upgrade(self.device_id), self._on_upgrade)
        c.start()
        c.publish(TOPIC_ONLINE, self._presence(DEVICE_IDLE))
        # heartbeat: the broker retains nothing, so a master that starts
        # (or restarts) after this agent would otherwise never see it —
        # and a registry-wired master gates ALL traffic on presence
        self._presence_interval = float(presence_interval_s)
        self._presence_stop = threading.Event()
        t = threading.Thread(target=self._presence_loop, daemon=True)
        self._presence_thread = t
        t.start()

    def _presence_loop(self) -> None:
        stop = self._presence_stop
        while not stop.wait(self._presence_interval):
            try:
                # announce the ACTUAL state: a heartbeat claiming IDLE
                # while jobs run would mislead schedulers gating on it.
                # list() snapshot: the receive thread mutates _watchers
                busy = any(t.is_alive()
                           for t in list(self._watchers.values()))
                self.center.publish(
                    TOPIC_ONLINE,
                    self._presence(DEVICE_RUNNING if busy
                                   else DEVICE_IDLE))
            except Exception:
                logger.exception("presence heartbeat failed")

    def stop(self) -> None:
        stop = getattr(self, "_presence_stop", None)
        if stop is not None:
            stop.set()
        self.center.stop()

    def _status(self, request_id: str, status: str, **extra) -> None:
        self._last_status[request_id] = {"status": status, **extra}
        payload = {"device_id": self.device_id, "request_id": request_id,
                   "status": status, "ts": time.time(), **extra}
        if self.device_token:
            # status frames carry an HMAC like presence proofs: without
            # one, any broker-authenticated peer could flip this device's
            # live job to FAILED/FINISHED on a registry-wired master.
            # Re-announcements mint a fresh nonce (proofs are single-use)
            from .accounts import status_proof
            payload["nonce"] = uuid.uuid4().hex
            payload["proof"] = status_proof(
                self.device_token, str(self.device_id), request_id,
                status, payload["ts"], payload["nonce"])
        self.center.publish(TOPIC_STATUS, payload)

    def _on_start(self, payload: dict) -> None:
        from .. import api
        request_id = str(payload.get("request_id") or uuid.uuid4().hex)
        reason = self._check(payload)
        if reason is not None:
            if reason == REASON_REPLAY:
                # byte-identical redelivery (at-least-once sender retry,
                # or an actual replay)
                if not self._reannounce(request_id):
                    logger.error("agent %s: dropping replayed start_train "
                                 "%s", self.device_id, request_id)
                return
            # refuse unauthenticated job dispatch — but NEVER by publishing
            # a status for a request id we already honor: an unauthenticated
            # peer echoing a live request id must not be able to flip that
            # job to FAILED on the master (status poisoning)
            logger.error("agent %s: REFUSING start_train %s — %s",
                         self.device_id, request_id, reason)
            if request_id not in self._seen_requests:
                # unknown id: tell the (possibly legitimate, misconfigured)
                # sender instead of leaving them waiting at PROVISIONING
                self._status(request_id, JOB_FAILED,
                             error=f"start_train refused: {reason}")
            return
        # idempotency: the master re-publishes start_train until it sees a
        # status (the broker has no retained messages, so a command sent
        # before this agent subscribed is simply gone) — a duplicate must
        # re-announce, never re-execute
        if request_id in self._seen_requests:
            self._reannounce(request_id)
            return
        self._seen_requests.add(request_id)
        self._status(request_id, JOB_PROVISIONING)
        if "job_yaml_content" in payload:
            # the master ships yaml CONTENT (master and agent need not
            # share a filesystem); materialize a job dir that also serves
            # as the default workspace
            from ..api import _runs_root
            jdir = os.path.join(_runs_root(), f"agent_{self.device_id}",
                                "jobs", request_id)
            os.makedirs(jdir, exist_ok=True)
            yaml_file = os.path.join(
                jdir, payload.get("job_yaml_name") or "job.yaml")
            with open(yaml_file, "w") as f:
                f.write(payload["job_yaml_content"])
        else:  # same-host dispatch may still send a path
            yaml_file = payload.get("job_yaml")
        if not yaml_file:
            # a malformed command must surface as FAILED, not stall the
            # requester's FSM at PROVISIONING until their timeout
            self._status(request_id, JOB_FAILED,
                         error="start_train without job yaml")
            return
        res = api.launch_job(yaml_file, device=self.device)
        if res.result_code != 0:
            self._status(request_id, JOB_FAILED,
                         error=res.result_message)
            return
        self.runs[request_id] = res.run_id
        self._status(request_id, JOB_RUNNING, run_id=res.run_id)
        t = threading.Thread(target=self._watch, args=(request_id,
                                                       res.run_id),
                             daemon=True)
        self._watchers[request_id] = t
        t.start()

    def _watch(self, request_id: str, run_id: str) -> None:
        from .. import api
        while True:
            status = api.run_status(run_id)
            if status is None:
                self._status(request_id, JOB_FAILED, error="run lost")
                return
            if status != api.STATUS_RUNNING:
                self._status(request_id, status, run_id=run_id,
                             log_tail=api.run_logs(run_id, tail=5))
                return
            time.sleep(self.poll_s)

    def _on_stop(self, payload: dict) -> None:
        from .. import api
        request_id = str(payload.get("request_id", ""))
        reason = self._check(payload)
        if reason is not None:
            logger.error("agent %s: REFUSING stop_train %s — %s",
                         self.device_id, request_id, reason)
            return
        run_id = self.runs.get(request_id)
        if run_id is None:
            self._status(request_id, JOB_FAILED, error="unknown run")
            return
        api.run_stop(run_id)
        # the watcher thread reports the terminal KILLED status

    def _on_upgrade(self, payload: dict) -> None:
        """OTA agent upgrade (reference ``scheduler_core/ota_upgrade.py``):
        a SIGNED command ships a zip package + version + sha256; the
        agent verifies the digest, stages the package under its runs dir,
        records the version, and reports UPGRADED. Process swap-over is
        deployment policy: with FEDML_TPU_AGENT_ALLOW_REEXEC=1 the daemon
        re-execs itself so the staged package (prepended to PYTHONPATH)
        takes effect; otherwise the supervisor restarts it."""
        import base64
        import hashlib
        import zipfile
        from ..api import _runs_root
        request_id = str(payload.get("request_id", ""))
        reason = self._check(payload)
        if reason is not None:
            if reason == REASON_REPLAY:
                # identical redelivery: re-announce, never fail
                if not self._reannounce(request_id):
                    logger.error("agent %s: dropping replayed upgrade %s",
                                 self.device_id, request_id)
                return
            logger.error("agent %s: REFUSING upgrade %s — %s",
                         self.device_id, request_id, reason)
            if request_id not in self._seen_requests:
                # unknown id only: an unauthenticated peer echoing a live
                # request id must not flip it to FAILED
                self._status(request_id, JOB_FAILED,
                             error=f"upgrade refused: {reason}")
            return
        if request_id in self._seen_requests:
            self._reannounce(request_id)  # fresh-MAC redelivery
            return
        self._seen_requests.add(request_id)
        version = str(payload.get("version", ""))
        blob = base64.b64decode(payload.get("package_b64", ""))
        digest = hashlib.sha256(blob).hexdigest()
        if not version or digest != payload.get("sha256"):
            logger.error("agent %s: upgrade %s digest mismatch",
                         self.device_id, request_id)
            self._status(request_id, JOB_FAILED,
                         error="upgrade package digest mismatch")
            return
        import re as _re
        if not _re.fullmatch(r"[A-Za-z0-9._-]{1,64}", version) \
                or version in (".", ".."):
            # the version names the staging directory — a signed payload
            # is still not trusted to choose arbitrary paths
            self._status(request_id, JOB_FAILED,
                         error="upgrade version must be a plain "
                               "identifier")
            return
        pkg_dir = os.path.join(_runs_root(), f"agent_{self.device_id}",
                               "pkgs", version)
        os.makedirs(pkg_dir, exist_ok=True)
        import io
        try:
            with zipfile.ZipFile(io.BytesIO(blob)) as z:
                # refuse traversal: every member must land inside pkg_dir
                for m in z.namelist():
                    dest = os.path.realpath(os.path.join(pkg_dir, m))
                    if not dest.startswith(
                            os.path.realpath(pkg_dir) + os.sep):
                        self._status(request_id, JOB_FAILED,
                                     error="upgrade package escapes "
                                           "target dir")
                        return
                z.extractall(pkg_dir)
        except (zipfile.BadZipFile, OSError, ValueError) as e:
            # a digest-valid but unreadable package must still resolve
            # the request (the master is waiting on this id)
            logger.error("agent %s: upgrade %s unusable package: %s",
                         self.device_id, request_id, e)
            self._status(request_id, JOB_FAILED,
                         error=f"upgrade package unusable: {e}")
            return
        cur = os.path.join(_runs_root(), f"agent_{self.device_id}",
                           "current_version.json")
        with open(cur + ".tmp", "w") as f:
            json.dump({"version": version, "path": pkg_dir,
                       "ts": time.time()}, f)
        os.replace(cur + ".tmp", cur)
        self.current_version = version
        logger.warning("agent %s: upgraded to %s (staged at %s)",
                       self.device_id, version, pkg_dir)
        self._status(request_id, "UPGRADED", version=version)
        if os.environ.get("FEDML_TPU_AGENT_ALLOW_REEXEC"):
            import sys
            # the UPGRADED status rides the async sender — it must reach
            # the wire BEFORE this process image is replaced
            self.center.flush(timeout_s=10.0)
            env = dict(os.environ)
            env["PYTHONPATH"] = (pkg_dir + os.pathsep
                                 + env.get("PYTHONPATH", ""))
            argv = [sys.executable, "-m", "fedml_tpu_torch.cli", "agent",
                    "--broker", f"{self.center._addr[0]}:"
                                f"{self.center._addr[1]}",
                    "--device-id", str(self.device_id)]
            if self.device is not None:
                argv += ["--device", str(self.device)]
            if self._insecure_open:
                argv.append("--insecure-open")  # or the new process
                # would refuse to start without the bind token
            os.execve(sys.executable, argv, env)


class MasterAgent:
    """Server-side agent (reference master protocol manager + status
    center): tracks the device table from presence/last-will messages and
    the per-request job status FSM from the status topic; dispatches
    start/stop commands."""

    def __init__(self, broker_host: str, broker_port: int, registry=None):
        from ..api import _runs_root
        self.center = MessageCenter(
            broker_host, broker_port,
            record_dir=os.path.join(_runs_root(), "agent_master"))
        self.devices: Dict[int, Dict[str, Any]] = {}
        self.jobs: Dict[str, Dict[str, Any]] = {}
        # optional AccountRegistry: with one wired, presence from devices
        # that are not enrolled (or present a bad/revoked token) is
        # DROPPED — dispatch can only target bound devices (reference
        # account_manager device binding)
        self.registry = registry
        # single-use presence nonces: a harvested proof (incl. the LWT,
        # whose freshness is necessarily exempt) must not be replayable —
        # at worst a captured LWT can be spent ONCE early, which the
        # heartbeat heals within one interval
        self._presence_nonces: Dict[str, float] = {}
        self._cv = threading.Condition()

    def start(self) -> None:
        self.center.subscribe(TOPIC_ONLINE, self._on_presence)
        self.center.subscribe(TOPIC_STATUS, self._on_status)
        self.center.start()

    def stop(self) -> None:
        self.center.stop()

    def _spend_nonce(self, key: str) -> bool:
        """Single-use nonce ledger shared by presence and status proofs
        (callers namespace their keys). False = already spent. Pruning:
        age out entries past the freshness window; under a flood of
        still-fresh nonces, evict oldest-first down to the cap rather
        than growing (and scanning) forever."""
        with self._cv:
            if key in self._presence_nonces:
                return False
            now = time.time()
            self._presence_nonces[key] = now
            if len(self._presence_nonces) > 8192:
                for k, t in list(self._presence_nonces.items()):
                    if now - t > 600:
                        del self._presence_nonces[k]
                while len(self._presence_nonces) > 8192:
                    self._presence_nonces.pop(
                        min(self._presence_nonces,
                            key=self._presence_nonces.get))
            return True

    def _on_presence(self, payload: dict) -> None:
        did = int(payload.get("device_id", -1))
        status = payload.get("status")
        if self.registry is not None:
            # OFFLINE = last-will: its proof was computed at connect time
            # (the broker fires it at crash time), so skip freshness; the
            # nonce ledger below still makes every proof single-use
            ok = self.registry.verify_presence(
                str(did), str(status), payload.get("ts"),
                payload.get("nonce"), payload.get("proof"),
                check_freshness=(status != DEVICE_OFFLINE))
            if not ok:
                logger.warning("master: dropping presence from unbound "
                               "device %s", did)
                return
            if not self._spend_nonce(f"{did}:{payload.get('nonce')}"):
                logger.warning("master: dropping replayed presence "
                               "for device %s", did)
                return
        with self._cv:
            dev = self.devices.setdefault(did, {})
            # MERGE, don't clobber: a heartbeat must not erase the
            # running-jobs bookkeeping _on_status maintains — a device
            # with live jobs stays RUNNING regardless of what the
            # (job-agnostic) presence loop says
            dev["ts"] = time.time()
            if status == DEVICE_OFFLINE or not dev.get("running"):
                dev["status"] = status
            self._cv.notify_all()

    def _on_status(self, payload: dict) -> None:
        did = int(payload.get("device_id", -1))
        if self.registry is not None:
            # status frames must carry a device-credential HMAC (like
            # presence proofs): a broker-authenticated peer without the
            # bind token must not be able to flip a bound device's live
            # job to FAILED/FINISHED, conjure a dispatchable device, or
            # poison the version column. verify_status also rejects
            # unenrolled/revoked devices and stale timestamps.
            ok = self.registry.verify_status(
                str(did), str(payload.get("request_id", "")),
                str(payload.get("status")), payload.get("ts"),
                payload.get("nonce"), payload.get("proof"))
            if not ok:
                logger.warning("master: dropping unauthenticated status "
                               "for device %s", did)
                return
            # single-use, same ledger/pruning as presence nonces (the
            # 'status:' prefix keeps the namespaces apart)
            if not self._spend_nonce(f"status:{did}:{payload.get('nonce')}"):
                logger.warning("master: dropping replayed status for "
                               "device %s", did)
                return
        if (payload.get("status") == "UPGRADED" and self.registry
                and payload.get("version")):
            # record only for upgrades THIS master dispatched to THAT
            # device: the MAC gate above authenticates the sender, but a
            # validly-bound device still must not rewrite its own version
            # column via UPGRADED statuses for jobs never dispatched
            with self._cv:
                job = self.jobs.get(str(payload.get("request_id", "")))
            if (job and job.get("kind") == "upgrade"
                    and int(job.get("device_id", -2)) == did):
                self.registry.record_version(
                    str(did), str(payload["version"]))
        with self._cv:
            rid = str(payload.get("request_id", ""))
            status = payload.get("status")
            job = self.jobs.setdefault(rid, {"history": []})
            job["history"].append(payload)
            job["status"] = status
            job["device_id"] = payload.get("device_id")
            if "run_id" in payload:
                job["run_id"] = payload["run_id"]
            dev = self.devices.setdefault(did, {})
            # a device is RUNNING while ANY of its jobs runs — one job's
            # PROVISIONING/terminal status must not mark a busy device idle
            running = dev.setdefault("running", set())
            if status in (JOB_RUNNING, JOB_PROVISIONING):
                running.add(rid)
            else:
                running.discard(rid)
            dev["status"] = DEVICE_RUNNING if running else DEVICE_IDLE
            dev["ts"] = time.time()
            self._cv.notify_all()

    # --- commands ----------------------------------------------------------
    def dispatch(self, device_id: int, job_yaml: str,
                 request_id: Optional[str] = None) -> str:
        """Send a start-train command; returns the request id used to track
        the job on the status FSM. The yaml CONTENT is shipped (not the
        path) so the agent can live on another machine; its workspace
        defaults to the agent-side job dir."""
        request_id = request_id or uuid.uuid4().hex
        path = os.path.abspath(os.path.expanduser(job_yaml))
        try:
            with open(path) as f:
                content = f.read()
        except OSError as e:
            # still dispatch: the slave reports the failure through the
            # status FSM so the caller sees FAILED rather than an exception
            content = None
            logger.warning("dispatch: cannot read %s (%s); sending path",
                           path, e)
        msg = {"request_id": request_id}
        if content is not None:
            msg["job_yaml_content"] = content
            msg["job_yaml_name"] = os.path.basename(path)
        else:
            msg["job_yaml"] = path
        self.center.publish(_topic_start(device_id), sign_job(msg))
        with self._cv:
            self.jobs.setdefault(request_id, {"history": []})[
                "device_id"] = device_id
        return request_id

    def dispatch_upgrade(self, device_id: int, package_zip: str,
                         version: str,
                         request_id: Optional[str] = None) -> str:
        """OTA: ship a signed upgrade package (zip bytes + sha256 +
        version) to a device agent. Returns the request id tracking the
        UPGRADED/FAILED status."""
        import base64
        import hashlib
        request_id = request_id or uuid.uuid4().hex
        with open(package_zip, "rb") as f:
            blob = f.read()
        msg = {"request_id": request_id, "version": str(version),
               "sha256": hashlib.sha256(blob).hexdigest(),
               "package_b64": base64.b64encode(blob).decode()}
        self.center.publish(_topic_upgrade(device_id), sign_job(msg))
        with self._cv:
            job = self.jobs.setdefault(request_id, {"history": []})
            job["device_id"] = device_id
            job["kind"] = "upgrade"
        return request_id

    def stop_job(self, request_id: str) -> None:
        with self._cv:
            device_id = self.jobs.get(request_id, {}).get("device_id")
        if device_id is None:
            raise KeyError(f"unknown request {request_id!r}")
        self.center.publish(_topic_stop(int(device_id)),
                            sign_job({"request_id": request_id}))

    # --- queries -----------------------------------------------------------
    def job_status(self, request_id: str) -> Optional[str]:
        with self._cv:
            return self.jobs.get(request_id, {}).get("status")

    def wait_for_status(self, request_id: str, statuses,
                        timeout_s: float = 60.0) -> Optional[str]:
        if isinstance(statuses, str):
            statuses = {statuses}
        deadline = time.time() + timeout_s
        with self._cv:
            while True:
                cur = self.jobs.get(request_id, {}).get("status")
                if cur in statuses:
                    return cur
                remaining = deadline - time.time()
                if remaining <= 0:
                    return cur
                self._cv.wait(timeout=min(remaining, 1.0))

    def wait_for_device(self, device_id: int, status: str,
                        timeout_s: float = 60.0) -> Optional[str]:
        deadline = time.time() + timeout_s
        with self._cv:
            while True:
                cur = self.devices.get(int(device_id), {}).get("status")
                if cur == status:
                    return cur
                remaining = deadline - time.time()
                if remaining <= 0:
                    return cur
                self._cv.wait(timeout=min(remaining, 1.0))


def launch_job_remote(job_yaml: str, device_id: int, master: MasterAgent,
                      timeout_s: float = 120.0,
                      redispatch_s: float = 3.0) -> Dict[str, Any]:
    """``fedml launch --remote`` analogue: dispatch through the master
    agent's broker and wait for a terminal status. The broker keeps no
    retained messages, so until the FIRST status arrives the command is
    re-published every ``redispatch_s`` (agents dedup by request id) —
    an agent that subscribed a beat after the dispatch still gets it."""
    rid = master.dispatch(device_id, job_yaml)
    deadline = time.time() + timeout_s
    while (master.job_status(rid) is None
           and time.time() < deadline):
        master.wait_for_status(rid, {JOB_PROVISIONING, JOB_RUNNING,
                                     JOB_FINISHED, JOB_FAILED, JOB_KILLED},
                               timeout_s=redispatch_s)
        if master.job_status(rid) is None:
            master.dispatch(device_id, job_yaml, request_id=rid)
    final = master.wait_for_status(
        rid, {JOB_FINISHED, JOB_FAILED, JOB_KILLED},
        timeout_s=max(deadline - time.time(), 0.0))
    with master._cv:
        info = dict(master.jobs.get(rid, {}))
    info["request_id"] = rid
    info["status"] = final
    return info
