"""The port's agent daemons (``fedml_tpu_torch.agents``) over its pub/sub
broker: the cases of ``tests/test_agents.py`` (master dispatches
start/stop-train over topics, slave executes via the run registry and
streams status back, last-will flags dead agents, the account registry,
OTA upgrades, status MACs), a training config dispatched to an agent that
trains on the CPU by request, and parity with the JAX package: the
job-signing, presence and status MACs bitwise equal in both packages, each
package's ``check_job`` accepting the other's signature, and a JAX master
dispatching through the port's broker to the port's agent."""

import os
import textwrap
import time

import pytest

from fedml_tpu_torch.agents import (DEVICE_IDLE, DEVICE_OFFLINE,
                                    JOB_FINISHED, JOB_KILLED, JOB_RUNNING,
                                    MasterAgent, SlaveAgent,
                                    launch_job_remote)
from fedml_tpu_torch.core.distributed.communication.pubsub import \
    PubSubBroker

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port


@pytest.fixture()
def registry(tmp_path, monkeypatch):
    monkeypatch.setenv("FEDML_TPU_RUNS_DIR", str(tmp_path / "runs"))
    # daemons are secure-by-default: a bind token is part of any deployment
    monkeypatch.setenv("FEDML_TPU_AGENT_SECRET", "test-bind-token")
    return tmp_path


@pytest.fixture()
def cluster(registry):
    broker = PubSubBroker()
    master = MasterAgent("127.0.0.1", broker.port)
    master.start()
    slave = SlaveAgent(device_id=7, broker_host="127.0.0.1",
                       broker_port=broker.port, poll_s=0.1)
    slave.start()
    assert master.wait_for_device(7, DEVICE_IDLE, timeout_s=10) == DEVICE_IDLE
    yield broker, master, slave
    slave.stop()
    master.stop()
    broker.stop()


def _job_yaml(tmp_path, body: str, name="job.yaml") -> str:
    path = tmp_path / name
    path.write_text(textwrap.dedent(body))
    return str(path)


def test_remote_launch_to_finished(cluster, registry):
    _, master, _ = cluster
    yml = _job_yaml(registry, """
        job: echo agent-ran > out.txt
        workspace: .
    """)
    info = launch_job_remote(yml, device_id=7, master=master, timeout_s=30)
    assert info["status"] == JOB_FINISHED, info
    # the full FSM was streamed: PROVISIONING -> RUNNING -> FINISHED
    seen = [h["status"] for h in info["history"]]
    assert seen[0] == "PROVISIONING" and JOB_RUNNING in seen
    # yaml CONTENT was shipped: the job ran in the AGENT's job dir, not in
    # the master-side yaml's directory
    out = (registry / "runs" / "agent_7" / "jobs" / info["request_id"]
           / "out.txt")
    assert out.read_text().strip() == "agent-ran"
    assert not (registry / "out.txt").exists()


def test_remote_stop_kills_run(cluster, registry):
    _, master, _ = cluster
    yml = _job_yaml(registry, """
        job: sleep 60
        workspace: .
    """)
    rid = master.dispatch(7, yml)
    assert master.wait_for_status(rid, JOB_RUNNING, timeout_s=30) \
        == JOB_RUNNING
    master.stop_job(rid)
    assert master.wait_for_status(rid, {JOB_KILLED}, timeout_s=30) \
        == JOB_KILLED


def test_bad_job_reports_failed(cluster, registry):
    _, master, _ = cluster
    info = launch_job_remote(str(registry / "missing.yaml"), device_id=7,
                             master=master, timeout_s=30)
    assert info["status"] == "FAILED"


def test_last_will_marks_device_offline(registry):
    broker = PubSubBroker()
    master = MasterAgent("127.0.0.1", broker.port)
    master.start()
    slave = SlaveAgent(device_id=3, broker_host="127.0.0.1",
                       broker_port=broker.port)
    slave.start()
    assert master.wait_for_device(3, DEVICE_IDLE, timeout_s=10) == DEVICE_IDLE
    # abnormal disconnect (no goodbye): the broker fires the last-will
    slave.center.stop(graceful=False)
    assert master.wait_for_device(3, DEVICE_OFFLINE, timeout_s=10) \
        == DEVICE_OFFLINE
    master.stop()
    broker.stop()


def test_message_center_records_sent(cluster, registry):
    _, master, slave = cluster
    yml = _job_yaml(registry, """
        job: "true"
        workspace: .
    """)
    launch_job_remote(yml, device_id=7, master=master, timeout_s=30)
    rec = registry / "runs" / "agent_7" / "message-sent-success-records.log"
    deadline = time.time() + 5
    while time.time() < deadline and not rec.exists():
        time.sleep(0.1)
    assert rec.exists() and rec.read_text().strip()


def test_cli_agent_and_remote_launch(registry):
    """Full process-level path: `fedml_tpu_torch.cli agent` daemon subprocess +
    `launch --remote` through the broker."""
    import subprocess
    import sys

    broker = PubSubBroker()
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["FEDML_TPU_RUNS_DIR"] = os.environ["FEDML_TPU_RUNS_DIR"]
    agent_proc = subprocess.Popen(
        [sys.executable, "-m", "fedml_tpu_torch.cli", "agent",
         "--broker", f"127.0.0.1:{broker.port}", "--device-id", "9"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        yml = _job_yaml(registry, """
            job: echo cli-remote-ok > cli_out.txt
            workspace: .
        """, name="cli_job.yaml")
        out = subprocess.run(
            [sys.executable, "-m", "fedml_tpu_torch.cli", "launch", yml,
             "--remote", f"127.0.0.1:{broker.port}", "--device-id", "9"],
            env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "FINISHED" in out.stdout
        hits = list((registry / "runs" / "agent_9" / "jobs").glob(
            "*/cli_out.txt"))
        assert hits and hits[0].read_text().strip() == "cli-remote-ok"
    finally:
        agent_proc.terminate()
        agent_proc.wait(timeout=10)
        broker.stop()


class TestAuth:
    """Broker HMAC handshake + agent bind token (VERDICT r3 item 9):
    unauthenticated peers cannot connect, and even an authenticated broker
    peer cannot start jobs without the agent secret."""

    def test_unauthenticated_connection_refused(self):
        import socket
        from fedml_tpu_torch.core.distributed.communication.pubsub import (
            PubSubBroker, _recv_frame, _send_frame, client_connect)

        broker = PubSubBroker(secret=b"hunter2")
        try:
            # no auth answer -> broker closes before honoring any frame
            raw = socket.create_connection(("127.0.0.1", broker.port))
            hello = _recv_frame(raw)
            assert hello["auth_required"] is True
            _send_frame(raw, {"kind": "sub", "topic": "x"})  # not an auth
            assert _recv_frame(raw) == {"kind": "auth_result", "ok": False}
            assert _recv_frame(raw) is None  # connection dropped
            raw.close()
            # wrong secret -> explicit reject + dropped; client_connect
            # surfaces it as PermissionError
            with pytest.raises(PermissionError):
                client_connect("127.0.0.1", broker.port, b"wrong")
            # right secret -> usable pub/sub
            a = client_connect("127.0.0.1", broker.port, b"hunter2")
            b = client_connect("127.0.0.1", broker.port, b"hunter2")
            _send_frame(a, {"kind": "sub", "topic": "t"})
            time.sleep(0.2)
            _send_frame(b, {"kind": "pub", "topic": "t", "payload": b"hi"})
            got = _recv_frame(a)
            assert got["payload"] == b"hi"
            a.close()
            b.close()
        finally:
            broker.stop()

    def test_unsigned_start_train_refused(self, registry, monkeypatch):
        import json as _json
        from fedml_tpu_torch.agents import MessageCenter, sign_job
        monkeypatch.setenv("FEDML_TPU_AGENT_SECRET", "bind-token")
        broker = PubSubBroker()
        statuses = []
        try:
            slave = SlaveAgent(device_id=9, broker_host="127.0.0.1",
                               broker_port=broker.port, poll_s=0.1)
            slave.start()
            spy = MessageCenter("127.0.0.1", broker.port)
            spy.subscribe("fl_client/mlops/status",
                          lambda p: statuses.append(p))
            spy.start()
            time.sleep(0.3)
            # forged start_train without the bind token
            spy.publish("flclient_agent/9/start_train",
                        {"request_id": "evil", "job_yaml_content": "x"})
            deadline = time.time() + 5
            while time.time() < deadline and not any(
                    s.get("request_id") == "evil" for s in statuses):
                time.sleep(0.1)
            evil = [s for s in statuses if s.get("request_id") == "evil"]
            assert evil and evil[-1]["status"] == "FAILED"
            assert "bind token" in evil[-1].get("error", "")
            # no run was provisioned
            assert slave.runs == {}
            # a signed stop for an unknown run is still honored (verify_job
            # passes with the right secret)
            assert sign_job({"request_id": "r"}).get("auth")
            spy.stop()
            slave.stop()
        finally:
            broker.stop()

    def test_tokenless_daemon_start_refused(self, registry, monkeypatch):
        """VERDICT r4 item 5: open deployment must be an explicit flag.
        Without FEDML_TPU_AGENT_SECRET the daemon refuses to construct,
        and the CLI exits 2 with the reason; insecure_open=True is the
        explicit opt-out."""
        monkeypatch.delenv("FEDML_TPU_AGENT_SECRET", raising=False)
        with pytest.raises(RuntimeError, match="bind token"):
            SlaveAgent(device_id=1, broker_host="127.0.0.1",
                       broker_port=1)  # never connects: ctor refuses first
        # explicit opt-out constructs fine (no broker contact yet)
        SlaveAgent(device_id=1, broker_host="127.0.0.1", broker_port=1,
                   insecure_open=True)
        # process-level: the CLI refuses too
        import subprocess
        import sys
        env = dict(os.environ)
        env.pop("FEDML_TPU_AGENT_SECRET", None)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        out = subprocess.run(
            [sys.executable, "-m", "fedml_tpu_torch.cli", "agent",
             "--broker", "127.0.0.1:1", "--device-id", "1"],
            env=env, capture_output=True, text=True, timeout=60)
        assert out.returncode == 2
        assert "bind token" in out.stderr

    def test_replayed_signed_command_rejected(self, monkeypatch):
        """ADVICE r4: a captured signed frame must not be honored twice
        (nonce/MAC ledger) nor after the freshness window (timestamp)."""
        import time as _time
        from fedml_tpu_torch.agents import (JOB_MAC_TTL_S, sign_job,
                                            verify_job)
        monkeypatch.setenv("FEDML_TPU_AGENT_SECRET", "tok")
        signed = sign_job({"request_id": "r1", "job_yaml": "x"})
        ledger = {}
        assert verify_job(signed, seen_macs=ledger) is True
        # exact replay of the captured frame: rejected by the ledger
        assert verify_job(signed, seen_macs=ledger) is False
        # stale frame (signed outside the freshness window): rejected even
        # with an empty ledger
        old = dict(signed)
        monkeypatch.setattr(_time, "time",
                            lambda: old["ts"] + JOB_MAC_TTL_S + 1)
        assert verify_job(old, seen_macs={}) is False
        # tampered-after-signing ts fails the MAC itself
        forged = dict(signed)
        forged["ts"] = signed["ts"] + 1
        assert verify_job(forged, seen_macs={}) is False

    def test_replay_ledger_survives_daemon_restart(self, registry,
                                                   monkeypatch):
        """A frame accepted before a crash must still be rejected by the
        relaunched daemon (the ledger is persisted, not process memory)."""
        from fedml_tpu_torch.agents import sign_job
        signed = sign_job({"request_id": "r1", "job_yaml": "x"})
        a1 = SlaveAgent(device_id=2, broker_host="127.0.0.1", broker_port=1)
        assert a1._check(signed) is None           # first delivery: accepted
        assert "already seen" in a1._check(signed)  # same-process replay
        a2 = SlaveAgent(device_id=2, broker_host="127.0.0.1", broker_port=1)
        assert "already seen" in a2._check(signed)  # post-restart replay

    def test_redelivered_start_reannounces_instead_of_failing(
            self, registry):
        """A byte-identical redelivery of an honored start_train (sender
        retry or replay) must re-announce the live job, not publish FAILED
        and poison its status on the master."""
        from fedml_tpu_torch.agents import JOB_FINISHED, sign_job
        a = SlaveAgent(device_id=4, broker_host="127.0.0.1", broker_port=1)
        signed = sign_job({"request_id": "live", "job_yaml_content": "x"})
        # simulate the already-honored state without launching anything
        assert a._check(signed) is None
        a._seen_requests.add("live")
        a.runs["live"] = "run-1"
        a._status("live", JOB_RUNNING, run_id="run-1")
        a._on_start(dict(signed))  # exact redelivery
        statuses = [q["payload"] for q in a.center._queue
                    if q["payload"].get("request_id") == "live"]
        assert statuses and statuses[-1]["status"] == JOB_RUNNING
        assert all(s["status"] != "FAILED" for s in statuses)
        # a redelivery AFTER the job finished re-announces FINISHED — it
        # must not resurrect the job to RUNNING on the master
        a._status("live", JOB_FINISHED, run_id="run-1")
        a._on_start(dict(signed))
        statuses = [q["payload"] for q in a.center._queue
                    if q["payload"].get("request_id") == "live"]
        assert statuses[-1]["status"] == JOB_FINISHED
        # a replayed frame for an UNKNOWN request is dropped silently
        # (no status poisoning), not FAILED
        n_before = len(a.center._queue)
        other = sign_job({"request_id": "gone", "job_yaml_content": "x"})
        assert a._check(other) is None  # consume its MAC into the ledger
        a._on_start(dict(other))        # now arrives as a replay
        poisoned = [q["payload"] for q in a.center._queue[n_before:]
                    if q["payload"].get("request_id") == "gone"]
        assert poisoned == []

    def test_unauthenticated_frame_cannot_poison_live_job(self, registry):
        """An unauthenticated peer echoing a LIVE request id must not be
        able to flip that job to FAILED on the master; unknown ids still
        get the refusal status so misconfigured senders aren't left
        hanging."""
        a = SlaveAgent(device_id=6, broker_host="127.0.0.1", broker_port=1)
        a._seen_requests.add("live")
        a._status("live", JOB_RUNNING, run_id="run-9")
        n_before = len(a.center._queue)
        a._on_start({"request_id": "live"})  # forged, no MAC
        assert all(q["payload"]["status"] != "FAILED"
                   for q in a.center._queue[n_before:]
                   if q["payload"].get("request_id") == "live")
        a._on_start({"request_id": "fresh"})  # forged, unknown id
        fresh = [q["payload"] for q in a.center._queue
                 if q["payload"].get("request_id") == "fresh"]
        assert fresh and fresh[-1]["status"] == "FAILED"


class TestAccountRegistry:
    """Device-binding account registry (reference account_manager.py):
    devices enroll with an API key, get a one-time token, and a
    registry-wired master only accepts presence from bound devices."""

    def test_register_verify_revoke(self, registry):
        from fedml_tpu_torch.agents.accounts import AccountRegistry
        reg = AccountRegistry(str(registry / "acc.db"))
        did, token = reg.register_device("api-key-1", device_id="11")
        assert reg.verify_device(did, token) is True
        assert reg.verify_device(did, "wrong") is False
        assert reg.verify_device("ghost", token) is False
        # same api key -> same account for a second device
        did2, _ = reg.register_device("api-key-1")
        accounts = {d["account_id"] for d in reg.devices()}
        assert len(accounts) == 1
        assert reg.revoke_device(did) is True
        assert reg.verify_device(did, token) is False  # revoked

    def test_reregister_and_revoked_ids_stay_dead(self, registry):
        """Re-binding an existing device id (any key) must be refused —
        otherwise a revocation could be undone or an identity hijacked."""
        from fedml_tpu_torch.agents.accounts import AccountRegistry
        reg = AccountRegistry(str(registry / "acc3.db"))
        did, token = reg.register_device("key-a", device_id="77")
        with pytest.raises(ValueError, match="already registered"):
            reg.register_device("key-b", device_id="77")
        reg.revoke_device(did)
        with pytest.raises(ValueError, match="already registered"):
            reg.register_device("key-a", device_id="77")
        assert reg.verify_device(did, token) is False
        # generated ids are numeric (agent topics address ints)
        gen_id, _ = reg.register_device("key-a")
        assert gen_id.isdigit()

    def test_status_from_unbound_device_dropped(self, registry):
        """With a registry wired, a broker peer must not conjure a
        dispatchable device (or poison versions) via the status topic."""
        from fedml_tpu_torch.agents import MessageCenter
        from fedml_tpu_torch.agents.accounts import AccountRegistry
        reg = AccountRegistry(str(registry / "acc4.db"))
        broker = PubSubBroker()
        try:
            master = MasterAgent("127.0.0.1", broker.port, registry=reg)
            master.start()
            spy = MessageCenter("127.0.0.1", broker.port)
            spy.start()
            spy.publish("fl_client/mlops/status", {
                "device_id": 44, "request_id": "x", "status": "FINISHED"})
            spy.publish("fl_client/mlops/status", {
                "device_id": 44, "request_id": "y", "status": "UPGRADED",
                "version": "evil"})
            time.sleep(0.8)
            assert 44 not in master.devices
            assert all(d["version"] != "evil" for d in reg.devices())
            spy.stop()
            master.stop()
        finally:
            broker.stop()

    def test_schema_migration_from_pre_mac_key_db(self, registry):
        """An accounts.db created before the mac_key column must open,
        migrate, and degrade gracefully (old devices fail proofs —
        re-enroll — instead of crashing every presence callback)."""
        import sqlite3
        from fedml_tpu_torch.agents.accounts import AccountRegistry
        path = str(registry / "old.db")
        con = sqlite3.connect(path)
        con.execute("""CREATE TABLE devices (
            device_id TEXT PRIMARY KEY, account_id TEXT NOT NULL,
            token_salt TEXT NOT NULL, token_hash TEXT NOT NULL,
            registered REAL NOT NULL, last_seen REAL,
            revoked INTEGER DEFAULT 0, version TEXT DEFAULT '')""")
        con.execute("INSERT INTO devices VALUES "
                    "('9', 'a', 's', 'h', 1.0, NULL, 0, '')")
        con.commit()
        con.close()
        reg = AccountRegistry(path)  # migrates
        assert reg.verify_presence("9", "IDLE", 1.0, "n", "p") is False
        did, token = reg.register_device("k")  # new enrolls still work
        from fedml_tpu_torch.agents.accounts import presence_proof
        import time as _t
        ts = _t.time()
        assert reg.verify_presence(did, "IDLE", ts, "n1",
                                   presence_proof(token, did, "IDLE",
                                                  ts, "n1"))

    def test_replayed_presence_nonce_rejected(self, registry):
        """A harvested presence proof (incl. the freshness-exempt LWT)
        is single-use at the master."""
        from fedml_tpu_torch.agents import MessageCenter
        from fedml_tpu_torch.agents.accounts import (AccountRegistry,
                                               presence_proof)
        import time as _t
        reg = AccountRegistry(str(registry / "acc6.db"))
        did, token = reg.register_device("k", device_id="31")
        broker = PubSubBroker()
        try:
            master = MasterAgent("127.0.0.1", broker.port, registry=reg)
            master.start()
            spy = MessageCenter("127.0.0.1", broker.port)
            spy.start()
            ts = _t.time()
            frame = {"device_id": 31, "status": "OFFLINE", "ts": ts,
                     "nonce": "nn", "proof": presence_proof(
                         token, "31", "OFFLINE", ts, "nn")}
            spy.publish("fl_client/agent/online", dict(frame))
            assert master.wait_for_device(31, "OFFLINE", timeout_s=10) \
                == "OFFLINE"
            # device comes back IDLE; the replayed OFFLINE must not land
            ts2 = _t.time()
            spy.publish("fl_client/agent/online", {
                "device_id": 31, "status": "IDLE", "ts": ts2,
                "nonce": "n2", "proof": presence_proof(
                    token, "31", "IDLE", ts2, "n2")})
            assert master.wait_for_device(31, "IDLE", timeout_s=10) \
                == "IDLE"
            spy.publish("fl_client/agent/online", dict(frame))  # replay
            time.sleep(0.6)
            assert master.devices[31]["status"] == "IDLE"
            spy.stop()
            master.stop()
        finally:
            broker.stop()

    def test_heartbeat_does_not_clobber_running_device(self, registry):
        """A presence heartbeat must not erase the master's running-jobs
        bookkeeping (it would make schedulers dispatch onto a busy
        device)."""
        broker = PubSubBroker()
        try:
            master = MasterAgent("127.0.0.1", broker.port)
            master.start()
            slave = SlaveAgent(device_id=8, broker_host="127.0.0.1",
                               broker_port=broker.port, poll_s=0.1)
            slave.start(presence_interval_s=0.2)
            assert master.wait_for_device(8, DEVICE_IDLE, timeout_s=10) \
                == DEVICE_IDLE
            yml = _job_yaml(registry, """
                job: sleep 30
                workspace: .
            """, name="busy.yaml")
            rid = master.dispatch(8, yml)
            assert master.wait_for_status(rid, JOB_RUNNING,
                                          timeout_s=30) == JOB_RUNNING
            time.sleep(0.8)  # several heartbeats later...
            assert master.devices[8]["status"] == "RUNNING"
            master.stop_job(rid)
            master.wait_for_status(rid, {JOB_KILLED}, timeout_s=30)
            slave.stop()
            master.stop()
        finally:
            broker.stop()

    def test_master_drops_unbound_presence(self, registry):
        from fedml_tpu_torch.agents.accounts import AccountRegistry
        reg = AccountRegistry(str(registry / "acc2.db"))
        _, token = reg.register_device("k", device_id="5")
        broker = PubSubBroker()
        try:
            master = MasterAgent("127.0.0.1", broker.port, registry=reg)
            master.start()
            # unbound device: no token
            rogue = SlaveAgent(device_id=6, broker_host="127.0.0.1",
                               broker_port=broker.port)
            rogue.start()
            # bound device: enrolled token
            bound = SlaveAgent(device_id=5, broker_host="127.0.0.1",
                               broker_port=broker.port,
                               device_token=token)
            bound.start()
            assert master.wait_for_device(5, DEVICE_IDLE, timeout_s=10) \
                == DEVICE_IDLE
            assert 6 not in master.devices  # rogue presence dropped
            rogue.stop()
            bound.stop()
            master.stop()
        finally:
            broker.stop()


class TestOTAUpgrade:
    """OTA agent upgrade (reference scheduler_core/ota_upgrade.py):
    signed package with sha256, staged under the agent dir, version
    recorded; bad digests and unsigned commands are refused."""

    def _package(self, tmp, content="print('v2')"):
        import hashlib
        import zipfile
        pkg = tmp / "agent_v2.zip"
        with zipfile.ZipFile(pkg, "w") as z:
            z.writestr("fedml_tpu_ext/__init__.py", content)
        blob = pkg.read_bytes()
        return str(pkg), hashlib.sha256(blob).hexdigest()

    def test_upgrade_staged_and_version_recorded(self, cluster, registry):
        import json as _json
        _, master, slave = cluster
        pkg, _sha = self._package(registry)
        rid = master.dispatch_upgrade(7, pkg, version="2.0.0")
        assert master.wait_for_status(rid, {"UPGRADED"}, timeout_s=20) \
            == "UPGRADED"
        assert slave.current_version == "2.0.0"
        staged = (registry / "runs" / "agent_7" / "pkgs" / "2.0.0"
                  / "fedml_tpu_ext" / "__init__.py")
        assert staged.exists()
        cur = _json.loads((registry / "runs" / "agent_7"
                           / "current_version.json").read_text())
        assert cur["version"] == "2.0.0"

    def test_bad_digest_refused(self, cluster, registry):
        import base64
        from fedml_tpu_torch.agents import sign_job, _topic_upgrade
        _, master, slave = cluster
        pkg, _sha = self._package(registry)
        msg = {"request_id": "bad-digest", "version": "6.6.6",
               "sha256": "0" * 64,
               "package_b64": base64.b64encode(
                   open(pkg, "rb").read()).decode()}
        master.center.publish(_topic_upgrade(7), sign_job(msg))
        assert master.wait_for_status("bad-digest", {"FAILED"},
                                      timeout_s=20) == "FAILED"
        assert slave.current_version != "6.6.6"

    def test_unsigned_upgrade_refused(self, cluster, registry):
        from fedml_tpu_torch.agents import _topic_upgrade
        _, master, slave = cluster
        master.center.publish(_topic_upgrade(7), {
            "request_id": "evil-up", "version": "9.9.9",
            "sha256": "x", "package_b64": ""})
        assert master.wait_for_status("evil-up", {"FAILED"},
                                      timeout_s=20) == "FAILED"
        assert slave.current_version is None \
            or slave.current_version != "9.9.9"

    def test_non_zip_package_resolves_failed(self, cluster, registry):
        """A digest-valid but unreadable package must still resolve the
        request id — the master is blocked on it."""
        notzip = registry / "notes.txt"
        notzip.write_text("not a zip")
        _, master, _ = cluster
        rid = master.dispatch_upgrade(7, str(notzip), version="4.0")
        assert master.wait_for_status(rid, {"FAILED"}, timeout_s=20) \
            == "FAILED"

    def test_path_choosing_version_refused(self, cluster, registry):
        """A signed payload must not choose the staging directory: the
        version string is an identifier, not a path."""
        pkg, _ = self._package(registry)
        _, master, _ = cluster
        rid = master.dispatch_upgrade(7, pkg, version="../../../tmp/evil")
        assert master.wait_for_status(rid, {"FAILED"}, timeout_s=20) \
            == "FAILED"
        assert not (registry / "tmp").exists()

    def test_presence_heartbeat_heals_late_master(self, registry):
        """A registry-wired master that starts AFTER the agent still
        learns of it via the presence heartbeat (no retained messages),
        and the proof on the wire is an HMAC — never the raw token."""
        from fedml_tpu_torch.agents import MessageCenter
        from fedml_tpu_torch.agents.accounts import AccountRegistry
        reg = AccountRegistry(str(registry / "acc5.db"))
        _, token = reg.register_device("k", device_id="21")
        broker = PubSubBroker()
        seen = []
        try:
            slave = SlaveAgent(device_id=21, broker_host="127.0.0.1",
                               broker_port=broker.port,
                               device_token=token)
            spy = MessageCenter("127.0.0.1", broker.port)
            spy.subscribe("fl_client/agent/online",
                          lambda p: seen.append(p))
            spy.start()
            slave.start(presence_interval_s=0.3)
            # master arrives late: first presence long gone
            time.sleep(0.5)
            master = MasterAgent("127.0.0.1", broker.port, registry=reg)
            master.start()
            assert master.wait_for_device(21, DEVICE_IDLE, timeout_s=10) \
                == DEVICE_IDLE
            # the credential itself never rides the topic
            assert seen and all(token not in str(p) for p in seen)
            assert all("proof" in p for p in seen)
            slave.stop()
            spy.stop()
            master.stop()
        finally:
            broker.stop()

    def test_traversal_package_refused(self, cluster, registry):
        import base64
        import hashlib
        import zipfile
        from fedml_tpu_torch.agents import sign_job, _topic_upgrade
        _, master, _ = cluster
        pkg = registry / "evil.zip"
        with zipfile.ZipFile(pkg, "w") as z:
            z.writestr("../../escape.py", "boom")
        blob = pkg.read_bytes()
        msg = {"request_id": "trav", "version": "3.0.0",
               "sha256": hashlib.sha256(blob).hexdigest(),
               "package_b64": base64.b64encode(blob).decode()}
        master.center.publish(_topic_upgrade(7), sign_job(msg))
        assert master.wait_for_status("trav", {"FAILED"},
                                      timeout_s=20) == "FAILED"
        assert not (registry / "runs" / "agent_7" / "escape.py").exists()
        assert not (registry / "escape.py").exists()


class TestStatusMAC:
    """Job-status frames carry a device-credential HMAC (like presence
    proofs): a broker-authenticated peer WITHOUT the bind token must not
    be able to flip a bound device's live job to FAILED/FINISHED on a
    registry-wired master (round-5 advisor)."""

    def _wired(self, registry, db):
        from fedml_tpu_torch.agents import MasterAgent, MessageCenter
        from fedml_tpu_torch.agents.accounts import AccountRegistry
        reg = AccountRegistry(str(registry / db))
        did, token = reg.register_device("k", device_id="31")
        broker = PubSubBroker()
        master = MasterAgent("127.0.0.1", broker.port, registry=reg)
        master.start()
        spy = MessageCenter("127.0.0.1", broker.port)
        spy.start()
        return reg, did, token, broker, master, spy

    @staticmethod
    def _signed_status(token, did, rid, status):
        import uuid as _uuid
        from fedml_tpu_torch.agents.accounts import status_proof
        ts = time.time()
        nonce = _uuid.uuid4().hex
        return {"device_id": int(did), "request_id": rid,
                "status": status, "ts": ts, "nonce": nonce,
                "proof": status_proof(token, did, rid, status, ts, nonce)}

    def test_forged_status_cannot_flip_bound_devices_job(self, registry):
        from fedml_tpu_torch.agents import JOB_RUNNING
        reg, did, token, broker, master, spy = self._wired(registry,
                                                           "st1.db")
        try:
            # legitimate, proof-carrying RUNNING status lands
            spy.publish("fl_client/mlops/status",
                        self._signed_status(token, did, "job-1",
                                            JOB_RUNNING))
            assert master.wait_for_status("job-1", {JOB_RUNNING},
                                          timeout_s=10) == JOB_RUNNING
            # forged frames (no proof / wrong proof) must not mutate it
            spy.publish("fl_client/mlops/status", {
                "device_id": 31, "request_id": "job-1",
                "status": "FAILED"})
            forged = self._signed_status(token, did, "job-1", "FINISHED")
            forged["proof"] = "0" * 64
            spy.publish("fl_client/mlops/status", forged)
            time.sleep(0.8)
            assert master.job_status("job-1") == JOB_RUNNING
            assert master.devices[31]["status"] == "RUNNING"
        finally:
            spy.stop()
            master.stop()
            broker.stop()

    def test_replayed_status_nonce_rejected(self, registry):
        from fedml_tpu_torch.agents import JOB_FINISHED, JOB_RUNNING
        reg, did, token, broker, master, spy = self._wired(registry,
                                                           "st2.db")
        try:
            running = self._signed_status(token, did, "job-2", JOB_RUNNING)
            spy.publish("fl_client/mlops/status", dict(running))
            assert master.wait_for_status("job-2", {JOB_RUNNING},
                                          timeout_s=10) == JOB_RUNNING
            spy.publish("fl_client/mlops/status",
                        self._signed_status(token, did, "job-2",
                                            JOB_FINISHED))
            assert master.wait_for_status("job-2", {JOB_FINISHED},
                                          timeout_s=10) == JOB_FINISHED
            # a harvested RUNNING frame replayed later must not resurrect
            spy.publish("fl_client/mlops/status", dict(running))
            time.sleep(0.8)
            assert master.job_status("job-2") == JOB_FINISHED
        finally:
            spy.stop()
            master.stop()
            broker.stop()

    def test_slave_attaches_status_proofs_end_to_end(self, registry):
        """A token-carrying slave's own statuses pass the MAC gate: the
        full dispatch->FAILED flow works through a registry-wired
        master (the job yaml is missing, so the slave reports FAILED —
        with a proof the master accepts)."""
        from fedml_tpu_torch.agents import SlaveAgent, launch_job_remote
        reg, did, token, broker, master, spy = self._wired(registry,
                                                           "st3.db")
        slave = SlaveAgent(device_id=31, broker_host="127.0.0.1",
                           broker_port=broker.port, poll_s=0.1,
                           device_token=token)
        slave.start()
        try:
            assert master.wait_for_device(31, DEVICE_IDLE,
                                          timeout_s=10) == DEVICE_IDLE
            info = launch_job_remote(str(registry / "missing.yaml"),
                                     device_id=31, master=master,
                                     timeout_s=30)
            assert info["status"] == "FAILED"
        finally:
            slave.stop()
            spy.stop()
            master.stop()
            broker.stop()


class TestTrainingJob:
    """A training config dispatched to an agent trains through the port's
    CLI: on the CPU when the agent is told so, and on a host with no card
    otherwise it fails naming the missing CUDA device."""

    CFG = """
        common_args:
          training_type: simulation
          random_seed: 0
        data_args:
          dataset: synthetic_mnist
        train_args:
          client_num_in_total: 2
          client_num_per_round: 2
          comm_round: 1
          batch_size: 16
          max_total_samples: 64
          synthetic_test_size: 64
        model_args:
          model: lr
        tracking_args:
          save_model_path: {ckpt}
    """

    @pytest.mark.parametrize("device", ["cpu", None])
    def test_agent_trains_on_the_device_it_was_given(self, registry,
                                                     device):
        import torch
        if device is None and torch.cuda.is_available():
            pytest.skip("this host has a card")
        ckpt = registry / "model.fmtpu"
        yml = _job_yaml(registry, self.CFG.format(ckpt=ckpt))
        broker = PubSubBroker()
        master = MasterAgent("127.0.0.1", broker.port)
        master.start()
        slave = SlaveAgent(device_id=12, broker_host="127.0.0.1",
                           broker_port=broker.port, poll_s=0.1,
                           device=device)
        slave.start()
        try:
            info = launch_job_remote(yml, device_id=12, master=master,
                                     timeout_s=120)
        finally:
            slave.stop()
            master.stop()
            broker.stop()
        if device == "cpu":
            assert info["status"] == JOB_FINISHED, info
            assert ckpt.exists()
        else:
            assert info["status"] == "FAILED", info
            assert not ckpt.exists()
            assert any("no CUDA device is available" in line
                       for line in info["history"][-1]["log_tail"])


class TestParityWithJax:
    """The agent plane's wire is the JAX package's: the same MACs bit for
    bit, signatures accepted across the packages, and a JAX master
    driving a port agent through a port broker."""

    def test_macs_bitwise_and_signatures_cross_verify(self, monkeypatch):
        import fedml_tpu.agents as jagents
        import fedml_tpu.agents.accounts as jacc
        import fedml_tpu_torch.agents as tagents
        import fedml_tpu_torch.agents.accounts as tacc
        secret = b"shared-bind-token"
        payload = {"request_id": "r-1", "job_yaml_content": "job: true\n",
                   "job_yaml_name": "j.yaml", "ts": 1700000000.25,
                   "nonce": "ab" * 16}
        assert tagents._job_mac(secret, payload) == \
            jagents._job_mac(secret, payload)
        args = ("tok-123", "31", "IDLE", 1700000000.5, "n-1")
        assert tacc.presence_proof(*args) == jacc.presence_proof(*args)
        sargs = ("tok-123", "31", "r-1", "FINISHED", 1700000000.5, "n-2")
        assert tacc.status_proof(*sargs) == jacc.status_proof(*sargs)
        assert tacc.mac_key_for("tok-123") == jacc.mac_key_for("tok-123")
        # each package accepts the other's fresh signature, once
        for sign, check in ((jagents.sign_job, tagents.check_job),
                            (tagents.sign_job, jagents.check_job)):
            signed = sign({"request_id": "x", "job_yaml": "y"}, secret)
            ledger = {}
            assert check(signed, secret, seen_macs=ledger) is None
            assert check(signed, secret, seen_macs=ledger) == \
                tagents.REASON_REPLAY == jagents.REASON_REPLAY
            assert check(signed, b"other") == "bad or missing bind token"

    def test_jax_master_dispatches_to_port_agent(self, registry):
        import fedml_tpu.agents as jagents
        broker = PubSubBroker()
        master = jagents.MasterAgent("127.0.0.1", broker.port)
        master.start()
        slave = SlaveAgent(device_id=17, broker_host="127.0.0.1",
                           broker_port=broker.port, poll_s=0.1)
        slave.start()
        try:
            assert master.wait_for_device(17, DEVICE_IDLE, timeout_s=10) \
                == DEVICE_IDLE
            yml = _job_yaml(registry, """
                job: echo mixed-ok > mixed.txt
                workspace: .
            """, name="mixed.yaml")
            info = jagents.launch_job_remote(yml, device_id=17,
                                             master=master, timeout_s=30)
            assert info["status"] == JOB_FINISHED, info
            out = (registry / "runs" / "agent_17" / "jobs"
                   / info["request_id"] / "mixed.txt")
            assert out.read_text().strip() == "mixed-ok"
        finally:
            slave.stop()
            master.stop()
            broker.stop()
