"""The port's comm stack and record plane against the JAX package.

* transports: a Message round trip through INPROC, TCP and gRPC on free
  loopback ports, decoded by both packages' codecs;
* ``FedMLCommManager``'s factory: its backends (PUBSUB and TRPC
  included) and its refusals;
* ``retry_with_backoff`` / ``retry_policy_from_args``: the reference's
  delays, attempts and deadline;
* ``ChaosCommManager``: loss / duplication / delay decisions and the
  ledger's ``links()`` equal to the reference interceptor's for the same
  plan and message sequence; ``FaultLedger.record_link`` / ``links`` /
  ``snapshot``;
* ``core/obs/schema.py`` pinned as a copy; ``core/mlops``: every record
  kind the port writes is valid under it and has the reference's keys;
  ``mlops.init``'s JSONL file; the device trace on ``torch.profiler`` and
  the system sampler's record;
* every knob left in ``runner.UNPORTED_KNOBS`` raises on the GPU engine,
  the SP loop and the cross-silo entry point.
"""

from __future__ import annotations

import json
import queue
import random
import socket
import threading
import time

import numpy as np
import pytest

from fedml_tpu.core.chaos import ChaosCommManager as JChaos
from fedml_tpu.core.chaos import FaultLedger as JLedger
from fedml_tpu.core.chaos import FaultPlan as JPlan
from fedml_tpu.core.distributed.communication import backoff as jbackoff
from fedml_tpu.core.distributed.communication.base_com_manager import \
    BaseCommunicationManager as JBase
from fedml_tpu.core.distributed.communication.message import \
    Message as JMessage
from fedml_tpu.core.obs import schema as jschema
from fedml_tpu_torch.core.chaos import ChaosCommManager as TChaos
from fedml_tpu_torch.core.chaos import FaultLedger as TLedger
from fedml_tpu_torch.core.chaos import FaultPlan as TPlan
from fedml_tpu_torch.core.distributed.communication import \
    backoff as tbackoff
from fedml_tpu_torch.core.distributed.communication.base_com_manager import \
    BaseCommunicationManager as TBase
from fedml_tpu_torch.core.distributed.communication.base_com_manager import \
    Observer
from fedml_tpu_torch.core.distributed.communication.message import Message
from fedml_tpu_torch.core.obs import schema as tschema

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port


def free_port_base(n: int) -> int:
    """A base port whose ``n`` ports from it are free on loopback (the
    transports listen on ``base + rank``); never a fixed port, so the
    test runs beside the JAX suite's."""
    rng = random.Random()
    for _ in range(200):
        base = rng.randint(20000, 60000 - n)
        socks = []
        try:
            for i in range(n):
                sk = socket.socket()
                socks.append(sk)
                sk.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for sk in socks:
                sk.close()
    raise RuntimeError("no free port range")


class _Collect(Observer):
    def __init__(self):
        self.got = queue.Queue()

    def receive_message(self, msg_type, msg):
        self.got.put(msg)


def _pair(backend):
    if backend == "INPROC":
        from fedml_tpu_torch.core.distributed.communication.inproc import (
            InProcBroker, InProcCommManager)
        broker = InProcBroker()
        return InProcCommManager(broker, 0), InProcCommManager(broker, 1)
    base = free_port_base(2)
    if backend == "TCP":
        from fedml_tpu_torch.core.distributed.communication.tcp import \
            TCPCommManager as M
    else:
        from fedml_tpu_torch.core.distributed.communication.grpc import \
            GRPCCommManager as M
    return M(0, base_port=base), M(1, base_port=base)


@pytest.mark.parametrize("backend", ["INPROC", "TCP", "GRPC"])
def test_message_round_trip(backend):
    if backend == "GRPC":
        pytest.importorskip("grpc")
    server, client = _pair(backend)
    sink = _Collect()
    server.add_observer(sink)
    loop = threading.Thread(target=server.handle_receive_message,
                            daemon=True)
    loop.start()
    try:
        rs = np.random.RandomState(0)
        wire = {"Dense_0/kernel": rs.randn(7, 3).astype(np.float32),
                "Dense_0/bias": np.arange(3, dtype=np.int64)}
        msg = Message(3, 1, 0)
        msg.add_params("model_params", wire)
        msg.add_params("num_samples", 12.0)
        msg.add_params("client_metrics", {"train_loss": 0.5})
        client.send_message(msg)
        got = sink.got.get(timeout=30)
    finally:
        server.stop_receive_message()
        client.stop_receive_message()
        loop.join(timeout=5)
    assert (got.get_type(), got.get_sender_id(), got.get_receiver_id()) == \
        (3, 1, 0)
    assert got.get("num_samples") == 12.0
    assert got.get("client_metrics") == {"train_loss": 0.5}
    for k, v in wire.items():
        np.testing.assert_array_equal(got.get("model_params")[k], v)
        assert got.get("model_params")[k].dtype == v.dtype
    # the JAX package decodes the port's frame to the same message
    back = JMessage.decode(msg.encode())
    assert back.get_type() == 3 and back.get("num_samples") == 12.0
    for k, v in wire.items():
        np.testing.assert_array_equal(back.get("model_params")[k], v)


def _manager(backend, **knobs):
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core.distributed import FedMLCommManager
    args = Arguments(**knobs)
    return FedMLCommManager(args, rank=0, size=2, backend=backend)


def test_comm_manager_factory_backends_and_refusals(monkeypatch):
    from fedml_tpu_torch.core.distributed.communication.inproc import (
        InProcBroker, InProcCommManager)
    from fedml_tpu_torch.core.distributed.communication.tcp import \
        TCPCommManager
    m = _manager("INPROC", inproc_broker=InProcBroker())
    assert isinstance(m.com_manager, InProcCommManager)
    base = free_port_base(1)
    m = _manager("tcp", tcp_base_port=base, comm_retry_max_attempts=1,
                 comm_retry_deadline_s=3.0)
    try:
        assert isinstance(m.com_manager, TCPCommManager)
        assert m.com_manager.base_port == base
        assert m.com_manager.retry == {"max_attempts": 1, "base_s": 0.2,
                                       "max_s": 2.0, "deadline_s": 3.0}
    finally:
        m.finish()
    with pytest.raises(ValueError, match="inproc_broker"):
        _manager("INPROC")
    # PUBSUB and its aliases: a broker's port is required; with one, the
    # manager is the pub/sub + object-store transport, subscribed to its
    # topic at the broker
    from fedml_tpu_torch.core.distributed.communication import pubsub
    broker = pubsub.PubSubBroker()
    try:
        for b in ("PUBSUB", "PUBSUB_STORAGE", "MQTT_S3_LOCAL"):
            with pytest.raises(ValueError, match="pubsub_broker_port"):
                _manager(b)
            m = _manager(b, pubsub_broker_port=broker.port, run_id="r7")
            assert isinstance(m.com_manager,
                              pubsub.PubSubStorageCommManager)
            assert m.com_manager._topic("*", 0) == "fedml_r7_*_0"
            m.finish()
    finally:
        broker.stop()
    # TRPC: the rpc world's address and size reach the transport (its
    # init_rpc waits for every rank: tests/test_torch_trpc.py runs it)
    from fedml_tpu_torch.core.distributed.communication import trpc
    seen = []

    class _TRPC(TBase):
        def __init__(self, *a, **k):
            super().__init__()
            seen.append((a, k))

        def send_message(self, msg):
            pass

        def handle_receive_message(self):
            pass

        def stop_receive_message(self):
            pass

    monkeypatch.setattr(trpc, "TRPCCommManager", _TRPC)
    _manager("TRPC", trpc_master_port=29612)
    assert seen == [((0, 2), {"master_addr": "127.0.0.1",
                              "master_port": 29612})]
    for b in ("MPI", "MQTT_S3", "MQTT_WEB3"):
        with pytest.raises(ImportError):
            _manager(b)
    with pytest.raises(ValueError, match="unknown comm backend"):
        _manager("CARRIER_PIGEON")
    # link-fault knobs wrap the transport, and only then
    m = _manager("INPROC", inproc_broker=InProcBroker(),
                 chaos_link_loss_prob=0.5)
    assert isinstance(m.com_manager, TChaos)


@pytest.mark.parametrize("fail_times,kw", [
    (3, dict(max_attempts=4, seed=3)),
    (6, dict(max_attempts=4, seed=3)),
    (2, dict(max_attempts=0)),
    (5, dict(max_attempts=10, base_s=0.5, max_s=4.0, factor=3.0, seed=9)),
    (5, dict(max_attempts=10, deadline_s=1.0, seed=1))])
def test_retry_with_backoff_matches_reference(fail_times, kw):
    def run(mod):
        slept, calls, retries = [], [0], []

        def fn():
            calls[0] += 1
            if calls[0] <= fail_times:
                raise OSError("refused")
            return "sent"

        try:
            out = mod.retry_with_backoff(
                fn, sleep=slept.append, on_retry=lambda a, d, e:
                retries.append((a, round(d, 9), type(e).__name__)), **kw)
        except OSError:
            out = "raised"
        return out, slept, calls[0], retries

    assert run(tbackoff) == run(jbackoff)
    for d in (dict(), dict(comm_retry_max_attempts=0,
                           comm_retry_deadline_s=2.5),
              dict(comm_retry_base_s=0.1, comm_retry_max_s=1.0)):
        from types import SimpleNamespace
        args = SimpleNamespace(**d)
        assert tbackoff.retry_policy_from_args(args) == \
            jbackoff.retry_policy_from_args(args)
    assert tbackoff.retry_policy_from_args(None) == \
        jbackoff.retry_policy_from_args(None)


def _recording(base):
    class Inner(base):
        def __init__(self):
            super().__init__()
            self.sent = []
            self.lock = threading.Lock()

        def send_message(self, msg):
            with self.lock:
                self.sent.append((msg.get_receiver_id(), msg.get_type(),
                                  msg.get("seq")))

        def handle_receive_message(self):
            pass

        def stop_receive_message(self):
            pass
    return Inner()


def test_interceptor_matches_reference():
    plan = dict(seed=17, link_loss_prob=0.2, link_dup_prob=0.2,
                link_delay_prob=0.2, link_delay_s=0.02)
    runs = []
    for Chaos, Plan, Base, Msg in ((TChaos, TPlan, TBase, Message),
                                   (JChaos, JPlan, JBase, JMessage)):
        inner = _recording(Base)
        cm = Chaos(inner, Plan(**plan), rank=2)
        for i in range(60):
            m = Msg(2 + i % 2, 2, i % 3)
            m.add_params("seq", i)
            cm.send_message(m)
        time.sleep(0.3)   # the delayed copies
        runs.append((sorted(inner.sent), cm.ledger.links()))
    (t_sent, t_links), (j_sent, j_links) = runs
    assert t_sent == j_sent
    assert t_links == j_links
    assert any(e["copies"] == 0 for e in t_links)
    assert any(e["copies"] == 2 for e in t_links)
    assert any(e["delay_s"] > 0 for e in t_links)


def test_fault_ledger_links_match_reference():
    from fedml_tpu_torch.core.obs import sink
    got = []
    sink.set_sink(got.append)
    try:
        lt, lj = TLedger(), JLedger()
        for led, plan in ((lt, TPlan(seed=3, link_loss_prob=0.5)),
                          (lj, JPlan(seed=3, link_loss_prob=0.5))):
            led.record_round(1, {"dropped": [2]}, {"reported": 3})
            for seq in range(6):
                led.record_link(0, 4, 2, plan.link_decision(0, 4, seq))
    finally:
        sink.set_sink(None)
    assert lt.links() == lj.links() and len(lt.links()) == 6
    assert lt.snapshot() == lj.snapshot()
    links = [r for r in got if "link" in r]
    assert [r["link"] for r in links] == lt.links()
    assert all(r["kind"] == "chaos" and not tschema.validate_record(r)
               for r in got)


def test_schema_is_the_reference_copy():
    assert tschema.ENVELOPE == jschema.ENVELOPE
    assert tschema.RECORD_SCHEMAS == jschema.RECORD_SCHEMAS
    recs = [{"kind": "round", "ts": 1.0, "run_id": "r", "round_idx": 2,
             "total_rounds": 3},
            {"kind": "round", "ts": 1.0, "run_id": "r", "round_idx": "2"},
            {"kind": "span", "ts": 1.0, "run_id": "r"},
            {"kind": "nope", "ts": 1.0, "run_id": "r"}, [1], "x"]
    for r in recs:
        assert tschema.validate_record(r) == jschema.validate_record(r)
    lines = [json.dumps(r) for r in recs[:4]] + ["{bad", ""]
    assert tschema.validate_lines(lines) == jschema.validate_lines(lines)


def _emit_all(mlops):
    mlops.log({"acc": 0.5}, step=3)
    mlops.log_metric({"loss": 1.0})
    mlops.log_round_info(10, 2)
    mlops.log_comm_round(2, 1234, compression="topk",
                         by_type={"3": {"bytes": 10, "count": 1}})
    mlops.log_chaos(round_idx=1, injected={"dropped": [1]},
                    observed={"reported": 3})
    mlops.log_chaos(link={"sender": 0, "receiver": 1, "msg_type": "2",
                          "copies": 0, "delay_s": 0.0})
    mlops.log_chaos(serving={"kind": "stall", "step_idx": 4})
    mlops.log_chaos(round_idx=3, arrivals=[{"client": 1, "staleness": 2}],
                    observed={"buffered": 1})
    mlops.log_selection(round_idx=1, strategy="oort", sampled=[1, 2],
                        excluded=[3], target_n=2, dropout_posterior=0.2)
    mlops.log_dispatch("rounds_fused", 0.25, rounds=2, compiles=0)
    mlops.log_training_status("ONLINE")
    mlops.log_aggregation_status("RUNNING")
    mlops.log_model_info(2, "/tmp/m.fmtpu")
    mlops.log_health("engine", "stalled", {"s": 1.0})
    with mlops.event("train", round_idx=1):
        pass
    mlops.event("agg", started=True)
    mlops.event("agg", started=False)


def test_mlops_records_valid_and_keyed_as_reference(monkeypatch):
    from fedml_tpu.core import mlops as jm
    from fedml_tpu_torch.core import mlops as tm
    from fedml_tpu_torch.core.obs import sink

    class Catch:
        def __init__(self):
            self.recs = []

        def emit(self, rec):
            self.recs.append(rec)

        def close(self):
            pass

    j = Catch()
    monkeypatch.setitem(jm._state, "sink", j)
    got = []
    sink.set_sink(got.append)
    try:
        _emit_all(tm)
        _emit_all(jm)
    finally:
        sink.set_sink(None)
    port = [r for r in got if r["kind"] != "span"]
    ref = [r for r in j.recs if r["kind"] != "span"]
    assert [(r["kind"], sorted(r)) for r in port] == \
        [(r["kind"], sorted(r)) for r in ref]
    for r in got:
        assert not tschema.validate_record(r), (r, tschema.validate_record(r))
    # the compile counter: the API, and 0 (the port compiles nothing)
    tm.install_compile_counter()
    assert tm.compile_count() == 0


def test_mlops_init_writes_the_run_jsonl(tmp_path):
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core import mlops
    fedml_tpu_torch.init(Arguments(log_file_dir=str(tmp_path),
                                   run_id="rec"))
    try:
        mlops.log_round_info(3, 0)
        mlops.log_comm_round(0, 99, by_type={"3": {"bytes": 99}})
        mlops.log_chaos(round_idx=0, observed={"reported": 1})
        with mlops.event("train", round_idx=0):
            pass
        path = mlops.log_path()
    finally:
        mlops.init(Arguments(enable_tracking=False))
    assert path == str(tmp_path / "run_rec.jsonl")
    lines = [ln for ln in open(path) if ln.strip()]
    kinds = [json.loads(ln)["kind"] for ln in lines]
    assert {"round", "comm", "chaos", "span", "event_start",
            "event_end"} <= set(kinds)
    assert all(json.loads(ln)["run_id"] == "rec" for ln in lines)
    assert tschema.validate_lines(lines) == []
    # tracking off: nothing is written
    assert mlops.log_path() is None


# every knob is ported (mesh_shape and ring attention were the last)
_UNPORTED_ON: dict = {}


@pytest.mark.parametrize("where", ["gpu", "sp", "cross_silo"])
def test_every_unported_knob_still_raises(where, monkeypatch):
    """No knob is left unported; the refusal still guards every entry
    point (a knob registered as unported raises there, naming itself and
    what is ported), and ``mesh_shape`` runs where it once raised: the
    engine's client axis of one rank, ignored by the SP loop and the
    cross-silo server as in the JAX package."""
    import fedml_tpu_torch
    from fedml_tpu_torch import runner
    assert set(_UNPORTED_ON) == set(runner.UNPORTED_KNOBS)
    monkeypatch.setitem(runner.UNPORTED_KNOBS, "some_future_knob", (None,))
    cfg = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=2,
               client_num_per_round=2, comm_round=1, max_total_samples=16)

    def run(**kw):
        if where == "cross_silo":
            return fedml_tpu_torch.run_cross_silo_server(
                device="cpu", backend="INPROC", enable_tracking=False,
                **cfg, **kw)
        return fedml_tpu_torch.run_simulation(
            backend=where, device="cpu", enable_tracking=False, **cfg, **kw)

    with pytest.raises(NotImplementedError, match="some_future_knob") as ei:
        run(some_future_knob=1)
    msg = str(ei.value)
    assert "cross-silo platform" in msg
    assert "SCAFFOLD" in msg and "client_slot_fold" in msg
    assert "22 defenses" in msg and "NbAFL" in msg
    assert "participant selection" in msg and "contribution assessment" \
        in msg
    if where != "cross_silo":
        assert run(mesh_shape={"client": 1})["rounds"] == 1


def test_mlops_device_trace_and_sys_sample(tmp_path):
    """The device trace runs on ``torch.profiler`` (a Chrome trace file),
    and one system sample is a valid ``sys_perf`` record."""
    import os

    import torch
    from fedml_tpu_torch.core import mlops
    path = mlops.start_device_trace(str(tmp_path))
    assert path == str(tmp_path)
    torch.ones(64).sum().item()
    out = mlops.stop_device_trace()
    assert out is not None and os.path.getsize(out) > 0
    assert json.load(open(out))["traceEvents"]
    assert mlops.stop_device_trace() is None     # none running
    rec = dict(mlops._sys_sample(), kind="sys_perf", ts=1.0, run_id="r")
    assert not tschema.validate_record(rec)
