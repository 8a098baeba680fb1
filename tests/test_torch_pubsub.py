"""The port's pub/sub + object-store transport (the MQTT+S3 control/data
split) and its content-addressed storage: the five cases of the JAX
package's ``tests/test_pubsub.py`` on the port, and a mixed session — a
JAX server with port silos over one broker and one store — ending at the
all-JAX session's params (house tolerance)."""

from __future__ import annotations

import copy
import os
import threading
import time

import numpy as np
import pytest

from fedml_tpu.cross_silo.horizontal import runner as JR
from fedml_tpu_torch.core.distributed.communication.base_com_manager import \
    Observer
from fedml_tpu_torch.core.distributed.communication.message import (
    Message, tree_to_wire)
from fedml_tpu_torch.core.distributed.communication.pubsub import (
    PubSubBroker, PubSubStorageCommManager)
from fedml_tpu_torch.core.distributed.distributed_storage import \
    LocalObjectStorage
from fedml_tpu_torch.cross_silo.horizontal import runner as TR

from test_torch_cross_silo import (SESSION, _close, _jax_params, _jax_parts,
                                   _port_parts, _run)
from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port


class Sink(Observer):
    def __init__(self):
        self.got = threading.Event()
        self.msg = None

    def receive_message(self, msg_type, msg):
        self.msg = msg
        self.got.set()


def test_object_storage_roundtrip(tmp_path):
    store = LocalObjectStorage(str(tmp_path))
    key = store.put_object(b"hello world")
    assert key.startswith("cas://")
    assert store.get_object(key) == b"hello world"
    params = {"w": np.arange(10.0, dtype=np.float32)}
    out = store.read_model(store.write_model(params))
    np.testing.assert_array_equal(out["w"], params["w"])
    # a corrupted object is refused, never returned
    with open(os.path.join(str(tmp_path), key.removeprefix("cas://")),
              "wb") as f:
        f.write(b"tampered")
    with pytest.raises(IOError, match="corruption"):
        store.get_object(key)


def test_pubsub_offloads_large_payloads(tmp_path):
    broker = PubSubBroker()
    store = LocalObjectStorage(str(tmp_path))
    a = PubSubStorageCommManager(1, broker_port=broker.port, storage=store,
                                 offload_threshold=1024)
    b = PubSubStorageCommManager(0, broker_port=broker.port, storage=store)
    sink = Sink()
    b.add_observer(sink)
    threading.Thread(target=b.handle_receive_message, daemon=True).start()
    time.sleep(0.1)
    big = tree_to_wire({"w": np.random.RandomState(0).randn(64, 64)
                        .astype(np.float32)})
    msg = Message("model_up", 1, 0)
    msg.add_params(Message.MSG_ARG_KEY_MODEL_PARAMS, big)
    msg.add_params(Message.MSG_ARG_KEY_NUM_SAMPLES, 32.0)
    a.send_message(msg)
    assert sink.got.wait(10), "message not delivered"
    got = sink.msg
    # the wire message carried a storage KEY, and the receive path
    # re-hydrated the payload from the object store
    assert got.get(Message.MSG_ARG_KEY_MODEL_PARAMS_URL, "").startswith(
        "cas://")
    np.testing.assert_array_equal(
        got.get(Message.MSG_ARG_KEY_MODEL_PARAMS)["w"], big["w"])
    assert len(os.listdir(str(tmp_path))) == 1
    a.stop_receive_message()
    b.stop_receive_message()
    broker.stop()


def test_pubsub_last_will_fires_on_dead_client(tmp_path):
    broker = PubSubBroker()
    store = LocalObjectStorage(str(tmp_path))
    server = PubSubStorageCommManager(0, broker_port=broker.port,
                                      storage=store)
    client = PubSubStorageCommManager(3, broker_port=broker.port,
                                      storage=store)
    sink = Sink()
    server.add_observer(sink)
    threading.Thread(target=server.handle_receive_message,
                     daemon=True).start()
    time.sleep(0.1)
    client._sock.close()  # HARD drop (no goodbye) -> broker fires the will
    assert sink.got.wait(10), "last-will not delivered"
    assert sink.msg.get_type() == "client_offline"
    assert sink.msg.get_sender_id() == 3
    server.stop_receive_message()
    broker.stop()


def test_pubsub_graceful_disconnect_clears_will(tmp_path):
    """MQTT LWT semantics: a clean goodbye must NOT fire the will."""
    broker = PubSubBroker()
    store = LocalObjectStorage(str(tmp_path))
    server = PubSubStorageCommManager(0, broker_port=broker.port,
                                      storage=store)
    client = PubSubStorageCommManager(4, broker_port=broker.port,
                                      storage=store)
    sink = Sink()
    server.add_observer(sink)
    threading.Thread(target=server.handle_receive_message,
                     daemon=True).start()
    time.sleep(0.1)
    client.stop_receive_message()  # graceful: disconnect frame first
    assert not sink.got.wait(1.5), "will fired on graceful disconnect"
    server.stop_receive_message()
    broker.stop()


def test_cross_silo_session_over_pubsub(tmp_path, monkeypatch):
    """A whole session with the control/data split: server + 2 silos over
    the broker, payloads through the object store, built through the
    backend factory (``backend: PUBSUB``, ``pubsub_broker_port``)."""
    monkeypatch.setenv("FEDML_TPU_STORAGE_DIR", str(tmp_path))
    broker = PubSubBroker()
    args, fed, bundle = _port_parts(dict(
        SESSION, client_num_in_total=2, client_num_per_round=2,
        comm_round=2, random_seed=7, backend="PUBSUB",
        pubsub_broker_port=broker.port))
    server = TR.build_server(args, fed, bundle, device="cpu")
    clients = [TR.build_client(args, fed, copy.deepcopy(bundle), rank=r,
                               device="cpu") for r in (1, 2)]
    assert type(server.com_manager).__name__ == "PubSubStorageCommManager"
    result = _run(server, clients)
    assert len(result["history"]) == 2
    assert result["final_test_acc"] > 0.6
    assert os.listdir(str(tmp_path))   # the models went through the store
    broker.stop()


def test_mixed_session_over_pubsub_matches_jax(tmp_path, monkeypatch):
    """A JAX server with port silos over one broker (the port's) and one
    store: both packages' frames and offloaded payloads interoperate, and
    the session ends at the all-JAX in-proc session's params."""
    monkeypatch.setenv("FEDML_TPU_STORAGE_DIR", str(tmp_path))
    broker = PubSubBroker()
    cfg = dict(SESSION, backend="PUBSUB", pubsub_broker_port=broker.port)
    jargs, jfed, jbundle = _jax_parts(cfg)
    targs, tfed, tbundle = _port_parts(cfg)
    ref = JR.run_cross_silo_inproc(*_jax_parts(SESSION))
    server = JR.build_server(jargs, jfed, jbundle, backend="PUBSUB")
    clients = [TR.build_client(targs, tfed, copy.deepcopy(tbundle), rank=r,
                               backend="PUBSUB", device="cpu")
               for r in range(1, 5)]
    got = _run(server, clients)
    _close(_jax_params(got), _jax_params(ref))
    assert len(got["history"]) == 3
    assert os.listdir(str(tmp_path))
    broker.stop()
