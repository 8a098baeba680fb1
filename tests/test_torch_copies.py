"""The modules the port copies from the JAX package (they import no JAX),
each pinned to the reference by behaviour on the same inputs: equal
outputs, bit for bit.

* ``core/algframe/params.py``: ``Params`` / ``Context``;
* ``data/synthetic.py``: every generator;
* ``data/leaf.py``: the LEAF reader, text and numeric users;
* ``data/acquire.py``'s offline part: ``BUNDLED_REAL`` and
  ``import_archive`` / ``_parse_local_archive`` (``.npz`` and CIFAR
  tarballs);
* the cross-silo runtime's copies: ``cross_silo/message_define.py``,
  ``base_com_manager.py`` (observers), ``fedml_comm_manager.py`` (the
  handler registry), the INPROC / TCP / gRPC transports' constants and
  broker, ``core/mlops/log_daemon.py`` (the shipper's POSTs to a local
  HTTP server), ``distributed_storage`` (keys and object files), the
  pub/sub frames and broker handshake across the packages, TRPC's names,
  the topologies and the Flow DAG (``test_comm.py::TestFlow::
  test_flow_chain_with_loop`` on both);
* ``serving/federated.py`` (what each role runs and serves, with the
  session and the endpoint stubbed) and the env contract of
  ``cross_silo/hierarchical/process_group.py`` (the same rendezvous,
  world size and rank from the same environment, each handed to its
  framework's initializer; a no-op at world size 1). ``interceptor.py``,
  ``schema.py``, ``backoff.py`` and
  ``core/wire/*`` are pinned in ``tests/test_torch_comm.py`` and
  ``tests/test_torch_compression.py``;
* secure aggregation's copies: ``core/mpc/channels.py`` (a blob sealed
  by either package opens with the other's, ``mask_seed`` and the key
  limbs agree), ``core/mpc/lightsecagg.py`` and ``core/fhe/paillier.py``;
  and, with ``cryptography`` hidden, the port imports and runs its other
  sessions while SA and LSA fail at build naming the package
  (``core/mpc``'s torch math is pinned in ``tests/test_torch_mpc.py``);
* the cross-device slice's copies: ``cross_device/message_define.py``,
  ``utils/paths.py`` (``confine_path`` accepts and refuses the same
  paths) and the native core's C++ source and C header (the same bytes;
  its binding is held bitwise in ``tests/test_torch_native.py``).
  ``core/fleet``, ``core/schedule`` and ``fa`` are held to the reference
  in ``tests/test_torch_fleet.py``, ``test_torch_schedule.py`` and
  ``test_torch_fa.py``.
"""

from __future__ import annotations

import io
import json
import os
import pickle
import tarfile

import numpy as np
import pytest

from fedml_tpu.core.algframe import params as jparams
from fedml_tpu.data import acquire as jacquire
from fedml_tpu.data import leaf as jleaf
from fedml_tpu.data import synthetic as jsyn
from fedml_tpu_torch.core.algframe import params as tparams
from fedml_tpu_torch.data import acquire as tacquire
from fedml_tpu_torch.data import leaf as tleaf
from fedml_tpu_torch.data import synthetic as tsyn

pytestmark = pytest.mark.torch_port


def _equal(a, b, kind_only=False):
    """Equal values, shapes and dtypes; ``kind_only``: the dtypes' kinds
    (JAX's containers hold integers in 32 bits)."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert (a.dtype.kind == b.dtype.kind if kind_only
            else a.dtype == b.dtype) and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_params_and_context():
    for mod in (jparams, tparams):
        p = mod.Params(a=1).add("b", 2)
        p["c"] = 3
        assert (p.a, p.get("b"), p["c"], p.get("z", 9)) == (1, 2, 3, 9)
        assert "b" in p and sorted(p.keys()) == ["a", "b", "c"]
        assert p.to_dict() == {"a": 1, "b": 2, "c": 3}
        mod.Context.reset()
        c1, c2 = mod.Context(), mod.Context()
        assert c1 is c2
        c1.add("round", 4)
        assert c2["round"] == 4
        mod.Context.reset()
        assert "round" not in mod.Context()
        mod.Context.reset()
    # the port's Context is its own singleton
    assert tparams.Context() is not jparams.Context()
    tparams.Context.reset()
    jparams.Context.reset()


@pytest.mark.parametrize("fn,kw", [
    ("make_classification", dict(n_samples=50, n_features=7, n_classes=3,
                                 seed=4, noise=1.5, flat=False,
                                 image_shape=(7, 1))),
    ("synthetic_mnist", dict(n_train=40, n_test=10, seed=2, flat=False)),
    ("synthetic_cifar10", dict(n_train=20, n_test=5, seed=1)),
    ("synthetic_federated", dict(alpha=0.5, beta=0.5, num_clients=5,
                                 seed=3)),
    ("synthetic_multilabel", dict(n_train=60, n_test=20, n_features=40,
                                  n_tags=6, seed=5)),
    ("synthetic_sequences", dict(n_train=30, n_test=10, seq_len=9,
                                 vocab=12, seed=6)),
    ("synthetic_segmentation", dict(n_train=6, n_test=2, size=8, seed=7)),
])
def test_synthetic_generators_equal(fn, kw):
    _equal(getattr(tsyn, fn)(**kw), getattr(jsyn, fn)(**kw))


def _write_leaf(root, users):
    for split, data in users.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        blob = {"users": sorted(data),
                "num_samples": [len(data[u]["x"]) for u in sorted(data)],
                "user_data": data}
        with open(os.path.join(root, split, "part.json"), "w") as f:
            json.dump(blob, f)


@pytest.mark.parametrize("kind", ["text", "numeric", "no_test"])
def test_leaf_reader_equal(tmp_path, kind):
    rs = np.random.RandomState(0)
    if kind == "text":
        users = {split: {f"u{i}": {
            "x": ["To be, or not {} ~".format(i * j) for j in range(3 + i)],
            "y": ["o be, or not {}~!".format(i * j) for j in range(3 + i)]}
            for i in range(3)} for split in ("train", "test")}
        task = "sequence"
    else:
        users = {split: {f"u{i}": {
            "x": rs.randn(4 + i, 5).tolist(),
            "y": rs.randint(0, 3, 4 + i).tolist()} for i in range(4)}
            for split in ("train", "test")}
        task = "classification"
    if kind == "no_test":
        del users["test"]
    _write_leaf(str(tmp_path), users)
    kw = dict(batch_size=2, num_classes=3, max_clients=3, task=task)
    ft = tleaf.load_leaf_dataset(str(tmp_path), **kw)
    fj = jleaf.load_leaf_dataset(str(tmp_path), **kw)
    for name in ("x", "y", "mask", "num_samples"):
        _equal(getattr(ft.train, name),
               np.asarray(getattr(fj.train, name)), kind_only=True)
    for name in ("x", "y", "mask"):
        _equal(ft.test[name], np.asarray(fj.test[name]), kind_only=True)
    assert ft.task == fj.task == task
    assert tleaf._LEAF_VOCAB == jleaf._LEAF_VOCAB
    assert len(tleaf._LEAF_VOCAB) == 80 and tleaf._CHAR_TO_ID["\n"] == 1
    assert tleaf.load_leaf_dataset(str(tmp_path / "absent"), 2, 3) is None


def _cifar_tarball(path, n=6):
    rs = np.random.RandomState(1)
    with tarfile.open(path, "w:gz") as tf:
        for name in ("data_batch_1", "data_batch_2", "test_batch",
                     "batches.meta"):
            d = {b"data": rs.randint(0, 256, (n, 3072)).astype(np.uint8),
                 b"labels": rs.randint(0, 10, n).tolist()}
            blob = pickle.dumps(d)
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))


def test_offline_archive_import_equal(tmp_path):
    assert tacquire.BUNDLED_REAL == jacquire.BUNDLED_REAL
    tar = str(tmp_path / "cifar-10-python.tar.gz")
    _cifar_tarball(tar)
    _equal(tacquire._parse_local_archive("cifar10", tar),
           jacquire._parse_local_archive("cifar10", tar))
    npz = str(tmp_path / "mnist.npz")
    rs = np.random.RandomState(2)
    np.savez(npz, x_train=rs.randint(0, 255, (8, 4, 4)),
             y_train=rs.randint(0, 10, 8), x_test=rs.randint(0, 255, (3, 4, 4)),
             y_test=rs.randint(0, 10, 3))
    for name, src in (("cifar10", tar), ("mnist", npz)):
        pt = tacquire.import_archive(name, src, str(tmp_path / "t"))
        pj = jacquire.import_archive(name, src, str(tmp_path / "j"))
        with np.load(pt) as a, np.load(pj) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                _equal(a[k], b[k])
    with pytest.raises(IOError):
        tacquire._parse_local_archive("svhn", str(tmp_path / "x.tar.gz"))


def test_ml_namespace_agg_matches_jax():
    """``fedml_tpu_torch.ml`` re-exports the trainers, and
    ``FedMLAggOperator.agg`` averages (n_k, params) pairs as the JAX
    package's does (house float32 tolerance)."""
    import jax.numpy as jnp
    import torch

    from fedml_tpu import ml as jml
    from fedml_tpu_torch import ml as tml
    for name in ("ClassificationTrainer", "SequenceTrainer",
                 "MultiLabelTrainer", "RegressionTrainer", "TrainerSpec",
                 "make_trainer_spec", "tree_weighted_average"):
        assert hasattr(tml, name) and hasattr(jml, name), name
    rs = np.random.RandomState(0)
    ps = [{"a": rs.randn(3, 4).astype(np.float32),
           "b": rs.randn(2).astype(np.float32)} for _ in range(3)]
    ns = (3, 5, 2)
    got = tml.FedMLAggOperator.agg(None, [
        (n, {k: torch.tensor(v) for k, v in p.items()})
        for n, p in zip(ns, ps)])
    want = jml.FedMLAggOperator.agg(None, [
        (n, {k: jnp.asarray(v) for k, v in p.items()})
        for n, p in zip(ns, ps)])
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-4, atol=2e-5)


def test_message_define_copy():
    from fedml_tpu.cross_silo.message_define import MyMessage as J
    from fedml_tpu_torch.cross_silo.message_define import MyMessage as T
    names = sorted(k for k in vars(J) if k.isupper())
    assert names == sorted(k for k in vars(T) if k.isupper())
    assert len(names) > 15
    assert all(getattr(J, k) == getattr(T, k) for k in names)


def _observed(base_mod, msg_mod):
    class Mgr(base_mod.BaseCommunicationManager):
        def send_message(self, msg):
            pass

        def handle_receive_message(self):
            pass

        def stop_receive_message(self):
            pass

    class Obs(base_mod.Observer):
        def __init__(self, tag, log):
            self.tag, self.log = tag, log

        def receive_message(self, msg_type, msg):
            self.log.append((self.tag, msg_type, msg.get_sender_id()))

    log, m = [], Mgr()
    a, b = Obs("a", log), Obs("b", log)
    m.add_observer(a)
    m.add_observer(b)
    m.notify(msg_mod.Message(3, 1, 0))
    m.remove_observer(a)
    m.remove_observer(a)
    m.notify(msg_mod.Message(5, 2, 0))
    abstract = sorted(base_mod.BaseCommunicationManager.__abstractmethods__)
    return log, abstract


def test_base_com_manager_copy():
    from fedml_tpu.core.distributed.communication import (
        base_com_manager as jb, message as jm)
    from fedml_tpu_torch.core.distributed.communication import (
        base_com_manager as tb, message as tm)
    assert _observed(tb, tm) == _observed(jb, jm)


def _registry(fcm, inproc, args):
    log = []

    class Mgr(fcm.FedMLCommManager):
        def register_message_receive_handlers(self):
            self.register_message_receive_handler(3, lambda m: log.append(
                ("h3", m.get_sender_id())))

    args.inproc_broker = inproc.InProcBroker()
    m = Mgr(args, rank=0, size=2, backend="inproc")
    m.register_message_receive_handlers()
    from importlib import import_module
    msg = import_module(fcm.__name__.rsplit(".", 1)[0]
                        + ".communication.message").Message
    m.receive_message(3, msg(3, 1, 0))
    m.receive_message(9, msg(9, 1, 0))   # no handler: logged, ignored
    return log, m.backend, m.get_sender_id(), type(m.com_manager).__name__


def test_fedml_comm_manager_copy():
    from fedml_tpu.arguments import Arguments as JA
    from fedml_tpu.core.distributed import fedml_comm_manager as jf
    from fedml_tpu.core.distributed.communication import inproc as ji
    from fedml_tpu_torch.arguments import Arguments as TA
    from fedml_tpu_torch.core.distributed import fedml_comm_manager as tf
    from fedml_tpu_torch.core.distributed.communication import inproc as ti
    assert _registry(tf, ti, TA()) == _registry(jf, ji, JA())


def test_transport_copies():
    from fedml_tpu.core.distributed.communication import grpc as jg
    from fedml_tpu.core.distributed.communication import tcp as jt
    from fedml_tpu_torch.core.distributed.communication import grpc as tg
    from fedml_tpu_torch.core.distributed.communication import tcp as tt
    from fedml_tpu_torch.core.distributed.communication import inproc as ti
    assert tt.TCP_BASE_PORT == jt.TCP_BASE_PORT == 29690
    assert (tg.GRPC_BASE_PORT, tg._SERVICE, tg._METHOD, tg.MAX_MSG) == (
        jg.GRPC_BASE_PORT, jg._SERVICE, jg._METHOD, jg.MAX_MSG)
    broker = ti.InProcBroker()
    broker.post(2, b"x")
    broker.post(2, b"y")
    assert broker.inbox(2).get_nowait() == b"x"
    assert broker.inbox(2).get_nowait() == b"y"
    assert broker.inbox(1).empty()


def _ship(daemon, path, port):
    ship = daemon.LogShipper(str(path), f"http://127.0.0.1:{port}/logs",
                             run_id="r", device_id="7", batch_lines=2,
                             interval_s=60.0)
    with open(path, "wb") as f:
        f.write(b"one\ntwo\r\nthree\rfour\n  \nfive")
    n = ship.pump_once()
    ship.stop(flush=True)
    return n, ship.shipped_lines, ship.failed_batches


def test_log_daemon_copy(tmp_path):
    import http.server
    import threading
    from fedml_tpu.core.mlops import log_daemon as jd
    from fedml_tpu_torch.core.mlops import log_daemon as td

    bodies = []

    class H(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers["Content-Length"])
            bodies.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), H)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        got = []
        for mod, name in ((td, "t.log"), (jd, "j.log")):
            bodies.clear()
            stats = _ship(mod, tmp_path / name, srv.server_address[1])
            got.append((stats, [dict(b) for b in bodies]))
    finally:
        srv.shutdown()
    assert got[0] == got[1]
    (n, shipped, failed), posted = got[0]
    assert (n, shipped, failed) == (4, 5, 0)
    assert [b["log_lines"] for b in posted] == [["one", "two"],
                                                ["three", "four"], ["five"]]


# --- the rest of the cross-silo runtime's copies: the object store, the
# pub/sub frames and handshake, TRPC's names, the topologies and the flow


def test_object_storage_copy(tmp_path):
    """The same blob and the same model tree give the same key and the
    same object file in both stores, and each reads the other's."""
    from fedml_tpu.core.distributed.distributed_storage import \
        LocalObjectStorage as J
    from fedml_tpu_torch.core.distributed.distributed_storage import \
        LocalObjectStorage as T
    j, t = J(str(tmp_path / "j")), T(str(tmp_path / "t"))
    assert J.SCHEME == T.SCHEME == "cas://"
    tree = {"Dense_0": {"kernel": np.arange(6, dtype=np.float32)
                        .reshape(2, 3), "bias": np.ones(3, np.float32)}}
    for put in ("put_object", "write_model"):
        arg = b"blob" if put == "put_object" else tree
        kj, kt = getattr(j, put)(arg), getattr(t, put)(arg)
        assert kj == kt
        digest = kj.removeprefix("cas://")
        with open(tmp_path / "j" / digest, "rb") as a, \
                open(tmp_path / "t" / digest, "rb") as b:
            assert a.read() == b.read()
    out = J(str(tmp_path / "t")).read_model(kt)
    _equal(out["Dense_0"]["kernel"], tree["Dense_0"]["kernel"])
    out = T(str(tmp_path / "j")).read_model(kj)
    _equal(out["Dense_0"]["bias"], tree["Dense_0"]["bias"])


def test_pubsub_frames_and_auth_copy(monkeypatch):
    """Frames are byte-equal; the HMAC challenge is the same; a JAX client
    authenticates against the port's broker and the port's against the
    JAX broker, and a wrong secret is refused by both."""
    import socket

    from fedml_tpu.core.distributed.communication import pubsub as jp
    from fedml_tpu_torch.core.distributed.communication import pubsub as tp

    frames = []
    for mod in (jp, tp):
        a, b = socket.socketpair()
        mod._send_frame(a, {"kind": "pub", "topic": "fedml_0_*_1",
                            "payload": b"\x00\x01"})
        frames.append(b.recv(1 << 16))
        a.close()
        b.close()
    assert frames[0] == frames[1]
    assert jp._challenge_mac(b"k", b"n") == tp._challenge_mac(b"k", b"n")
    monkeypatch.setenv("FEDML_TPU_BROKER_SECRET", "s3")
    assert jp.broker_secret() == tp.broker_secret() == b"s3"
    for broker_mod, client_mod in ((tp, jp), (jp, tp)):
        broker = broker_mod.PubSubBroker(secret=b"right")
        try:
            sock = client_mod.client_connect("127.0.0.1", broker.port,
                                             secret=b"right")
            sock.close()
            with pytest.raises(PermissionError):
                client_mod.client_connect("127.0.0.1", broker.port,
                                          secret=b"wrong")
        finally:
            broker.stop()
    assert jp.PubSubStorageCommManager.OFFLOAD_KEYS == \
        tp.PubSubStorageCommManager.OFFLOAD_KEYS


def test_trpc_copy():
    from fedml_tpu.core.distributed.communication import trpc as jt
    from fedml_tpu_torch.core.distributed.communication import trpc as tt
    assert jt._WORKER_FMT == tt._WORKER_FMT
    assert tt._deliver(bytearray(b"abc")) is True
    assert tt._INBOX.get_nowait() == b"abc"


@pytest.mark.parametrize("n,k,seed", [(6, 2, 0), (7, 4, 3), (5, 3, 1)])
def test_topology_copy(n, k, seed):
    from fedml_tpu.core.distributed import topology as jt
    from fedml_tpu_torch.core.distributed import topology as tt
    for cls in ("SymmetricTopologyManager", "AsymmetricTopologyManager"):
        got = []
        for mod in (jt, tt):
            tm = getattr(mod, cls)(n, neighbor_num=k, seed=seed)
            tm.generate_topology()
            got.append((tm.mixing_matrix(),
                        [tm.get_in_neighbor_idx_list(i) for i in range(n)],
                        [tm.get_out_neighbor_idx_list(i) for i in range(n)],
                        [tm.get_in_neighbor_weights(i) for i in range(n)],
                        tm.to_ppermute_pairs()))
        _equal(got[0][0], got[1][0])
        assert got[0][1:] == got[1][1:]
        np.testing.assert_allclose(got[1][0].sum(axis=1), 1.0, atol=1e-9)
    adj = np.random.RandomState(seed).rand(n, n) > 0.6
    custom = []
    for mod in (jt, tt):
        tm = mod.SymmetricTopologyManager(n)
        tm.generate_custom_topology(adj)
        custom.append(tm.mixing_matrix())
    _equal(custom[0], custom[1])


def _flow_chain(mod):
    """``test_comm.py::TestFlow::test_flow_chain_with_loop`` on ``mod``'s
    flow, with each step's calls logged."""
    calls = []

    class Server(mod.FedMLExecutor):
        def init_model(self):
            calls.append(("init",))
            self.set_params(0)
            return 0

        def aggregate(self, v=None):
            calls.append(("agg", v))
            self.set_params(self.get_params() + (v or 0))
            return self.get_params()

    class Client(mod.FedMLExecutor):
        def train(self, v=None):
            calls.append(("train", v))
            return (v or 0) + 1

    class A:
        comm_round = 3

    server, client = Server(0), Client(1, [0])
    flow = mod.FedMLAlgorithmFlow(A(), server)
    with pytest.raises(RuntimeError, match="build"):
        flow.run()
    flow.add_flow("init", server.init_model)
    flow.add_flow("train", client.train, loop=True)
    flow.add_flow("agg", server.aggregate, loop=True)
    flow.add_flow("done", server.aggregate)
    flow.build()
    out = flow.run()
    # 3 loop iterations: agg accumulates; the final agg adds again
    assert server.get_params() >= 3
    with pytest.raises(ValueError, match="no flows"):
        mod.FedMLAlgorithmFlow(A()).build()
    return out, server.get_params(), calls, client.neighbor_id_list


def test_flow_chain_with_loop_copy():
    from fedml_tpu.core.distributed import flow as jf
    from fedml_tpu_torch.core.distributed import flow as tf
    assert _flow_chain(tf) == _flow_chain(jf)


@pytest.mark.parametrize("env,kw", [
    ({"WORLD_SIZE": "2", "RANK": "1", "MASTER_ADDR": "10.0.0.7",
      "MASTER_PORT": "29411"}, {}),
    ({"WORLD_SIZE": "4", "RANK": "3"}, {}),
    ({}, {"coordinator": "127.0.0.1:1234", "num_hosts": 3,
          "host_rank": 2}),
    ({"WORLD_SIZE": "1"}, {}), ({}, {})])
def test_process_group_env_contract_copy(monkeypatch, env, kw):
    import jax
    import torch.distributed as dist
    from fedml_tpu.cross_silo.hierarchical import process_group as jpg
    from fedml_tpu_torch.cross_silo.hierarchical import process_group as tpg
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = {}
    monkeypatch.setattr(jpg, "_initialized", False)
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **a: seen.setdefault("jax", a))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **a: seen.setdefault("torch", a))
    up = (jpg.init_silo_process_group(**kw),
          tpg.init_silo_process_group(**kw, device="cpu"))
    assert up[0] == up[1] == (int(env.get("WORLD_SIZE",
                                          kw.get("num_hosts", 1))) > 1)
    if not up[0]:
        assert seen == {}
        return
    j, t = seen["jax"], seen["torch"]
    assert t["init_method"] == "tcp://" + j["coordinator_address"]
    assert (t["world_size"], t["rank"]) == (j["num_processes"],
                                            j["process_id"])
    assert t["backend"] == "gloo"


@pytest.mark.parametrize("device,backend", [("cuda", "nccl"),
                                            ("cuda:1", "nccl"),
                                            ("cpu", "gloo")])
def test_process_group_backend_follows_the_silo_device(monkeypatch, device,
                                                       backend):
    """The backend comes from the silo's device, not from whether the host
    has a card (the rendezvous is stubbed: no card is touched)."""
    import torch.distributed as dist
    from fedml_tpu_torch.cross_silo.hierarchical import process_group as tpg
    seen = {}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **a: seen.update(a))
    assert tpg.init_silo_process_group("127.0.0.1:1234", 2, 1, device=device)
    assert seen["backend"] == backend


@pytest.mark.parametrize("role", ["server", "client"])
def test_federated_serving_copy(monkeypatch, role):
    """Both runners with the session and the endpoint stubbed: the same
    calls (the predictor's params, the port, start vs run) and the same
    result."""
    import fedml_tpu.serving as js
    import fedml_tpu_torch.serving as ts
    from fedml_tpu.cross_silo.horizontal import runner as jr
    from fedml_tpu.serving import federated as jf
    from fedml_tpu_torch.cross_silo.horizontal import runner as tr
    from fedml_tpu_torch.serving import federated as tf

    def stubs(runner_mod, serving_mod, log):
        class Session:
            def __init__(self, *a, **k):
                log.append(("session",))

            def run(self, comm_round=None):
                return {"params": {"w": 1.0}, "final_test_acc": 0.5}

        class Predictor:
            def __init__(self, bundle, params, **k):
                log.append(("predictor", bundle, params))

        class Endpoint:
            port = 4321

            def __init__(self, predictor, port=0):
                log.append(("endpoint", port))

            def start(self):
                log.append(("start",))

            def run(self):
                log.append(("run",))

        monkeypatch.setattr(runner_mod, "CrossSiloRunner", Session)
        monkeypatch.setattr(serving_mod, "CheckpointPredictor", Predictor)
        monkeypatch.setattr(serving_mod, "FedMLInferenceRunner", Endpoint)

    logs, results = [], []
    for runner_mod, serving_mod, mod, extra in (
            (jr, js, jf, {}), (tr, ts, tf, {"device": "cpu"})):
        log = []
        stubs(runner_mod, serving_mod, log)
        for block in (False, True):
            args = type("A", (), dict(role=role, serving_port=77,
                                      serving_block=block))()
            r = mod.FederatedServingRunner(args, "fed", "bundle", **extra)
            results.append(r.run())
        logs.append(log)
    assert logs[0] == logs[1]
    assert results[:2] == results[2:]
    if role == "server":
        assert results[0]["serving_port"] == 4321
        assert ("start",) in logs[0] and ("run",) in logs[0]


def test_channels_copy():
    pytest.importorskip("cryptography")
    from fedml_tpu.core.mpc import channels as jch
    from fedml_tpu_torch.core.mpc import channels as tch
    a_sk, a_pk = jch.keygen()
    b_sk, b_pk = tch.keygen()
    aad = tch.pair_aad(0, 1, b"sa-round-3")
    assert aad == jch.pair_aad(0, 1, b"sa-round-3")
    for seal, opener, sk_s, sk_o, pk_s, pk_o in (
            (jch.seal, tch.open_sealed, a_sk, b_sk, a_pk, b_pk),
            (tch.seal, jch.open_sealed, b_sk, a_sk, b_pk, a_pk)):
        blob = seal(sk_s, pk_o, b"share", aad=aad)
        assert opener(sk_o, pk_s, blob, aad=aad) == b"share"
        with pytest.raises(ValueError):     # another round's aad
            opener(sk_o, pk_s, blob, aad=tch.pair_aad(0, 1, b"sa-round-4"))
    assert tch.mask_seed(b_sk, a_pk) == jch.mask_seed(a_sk, b_pk)
    assert tch.key_to_limbs(b_sk) == jch.key_to_limbs(
        jch.limbs_to_key(tch.key_to_limbs(b_sk)))
    assert tch.private_bytes(tch.limbs_to_key(tch.key_to_limbs(b_sk))) == \
        tch.private_bytes(b_sk)
    seed = (1 << 127) + 12345
    limbs = tch.int_to_limbs(seed, tch.SEED_LIMBS)
    assert limbs == jch.int_to_limbs(seed, jch.SEED_LIMBS)
    assert tch.limbs_to_int(limbs) == seed
    assert (tch.KEY_LIMBS, tch.KEY_LIMB_BITS, tch.SEED_BITS) == \
        (jch.KEY_LIMBS, jch.KEY_LIMB_BITS, jch.SEED_BITS)
    draws = tch.secret_rng().randint(0, 7, size=(50,))
    assert draws.shape == (50,) and draws.min() >= 0 and draws.max() < 7


def test_lightsecagg_and_paillier_copies():
    from fedml_tpu.core.fhe import paillier as jp
    from fedml_tpu.core.mpc import lightsecagg as jl
    from fedml_tpu_torch.core.fhe import paillier as tp
    from fedml_tpu_torch.core.mpc import lightsecagg as tl
    z = np.random.RandomState(0).randint(0, 2**31 - 1, 24).astype(np.uint64)
    _equal(tl.mask_encoding(z, 5, 1, 3, np.random.RandomState(1)),
           jl.mask_encoding(z, 5, 1, 3, np.random.RandomState(1)))
    for n, t, d in ((4, 2, 1), (6, 1, 3)):
        for a, b in zip(tl._eval_points(n, t, d), jl._eval_points(n, t, d)):
            _equal(a, b)
    p, q = 1000000007, 998244353
    jpub, jpriv = jp.keygen(seed_primes=(p, q))
    tpub, tpriv = tp.keygen(seed_primes=(p, q))
    assert (tpub.n, tpriv.lam, tpriv.mu) == (jpub.n, jpriv.lam, jpriv.mu)
    assert tp._slot_bias(48, 256) == jp._slot_bias(48, 256)
    assert [tp._is_probable_prime(k) for k in range(3, 200)] == \
        [jp._is_probable_prime(k) for k in range(3, 200)]
    c = tpub.encrypt_int(424242)
    assert jpriv.decrypt_int(c) == tpriv.decrypt_int(c) == 424242


_NO_CRYPTOGRAPHY = r"""
import sys
sys.modules["cryptography"] = None       # a host without the package
import fedml_tpu_torch
from fedml_tpu_torch import data, model
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.core import fhe, mpc
from fedml_tpu_torch.core.distributed.communication.inproc import InProcBroker
from fedml_tpu_torch.cross_silo.horizontal.runner import run_cross_silo_inproc
kw = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=2,
          client_num_per_round=2, comm_round=1, max_total_samples=64,
          training_type="cross_silo", enable_tracking=False)
args = Arguments(**kw)
fed, od = data.load(args)
r = run_cross_silo_inproc(args, fed, model.create(args, od, fed.input_shape),
                          device="cpu")
assert len(r["history"]) == 1, r
assert int(mpc.sum_mod_p(mpc.quantize(__import__("torch").ones(2, 3)))[0])     == 2 * 65536
errors = []
for fo in ("SA", "LSA"):
    for role in ("server", "client"):
        try:
            fedml_tpu_torch.cross_silo_runner(
                role, device="cpu", backend="INPROC", rank=1,
                inproc_broker=InProcBroker(), federated_optimizer=fo, **kw)
        except ModuleNotFoundError as e:
            errors.append((e.name.split(".")[0], "cryptography" in str(e)))
print(errors)
"""


def test_without_cryptography_the_port_runs_and_secure_sessions_name_it():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = root
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "-c", _NO_CRYPTOGRAPHY], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == \
        str([("cryptography", True)] * 4), out.stdout


def test_cross_device_copies(tmp_path):
    from fedml_tpu.cross_device.message_define import DeviceMessage as JMsg
    from fedml_tpu.utils.paths import confine_path as jconfine
    from fedml_tpu_torch.cross_device.message_define import \
        DeviceMessage as TMsg
    from fedml_tpu_torch.utils.paths import confine_path as tconfine

    def names(cls):
        return {k: v for k, v in vars(cls).items() if k.isupper()}
    assert names(TMsg) == names(JMsg) and names(TMsg)
    root = tmp_path / "cache"
    root.mkdir()
    (root / "ok.npk").write_bytes(b"x")
    for path in (str(root / "ok.npk"), str(root / "sub" / "x.npk"),
                 "/etc/passwd", str(root / ".." / "escape.npk")):
        outs = []
        for fn in (jconfine, tconfine):
            try:
                outs.append(fn(path, str(root)))
            except ValueError as e:
                outs.append(("raises", str(e)))
        assert outs[0] == outs[1], path
    import fedml_tpu.native as jn
    import fedml_tpu_torch.native as tn
    for rel in ("mobilenn.cpp", os.path.join("include", "fedml_client.h")):
        with open(os.path.join(os.path.dirname(jn.__file__), rel),
                  "rb") as f, open(os.path.join(
                      os.path.dirname(tn.__file__), rel), "rb") as g:
            assert f.read() == g.read(), rel


# -- the last data readers (their arrays: tests/test_torch_readers.py) -----

READER_COPIES = ("edge_case", "finance", "images", "tff_h5", "fednlp_h5")

_NO_H5PY_PIL = r"""
import sys
sys.modules["h5py"] = None               # a host without either package
sys.modules["PIL"] = None
import importlib
for name in %r:
    importlib.import_module("fedml_tpu_torch.data." + name)
from fedml_tpu_torch import data
from fedml_tpu_torch.arguments import Arguments
fed, n = data.load(Arguments(dataset="synthetic_seg", client_num_in_total=2))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "optax", "fedml_tpu"))
print(n, fed.task, bad)
""" % (READER_COPIES,)


@pytest.mark.parametrize("name", READER_COPIES)
def test_reader_copies_keep_the_public_names(name):
    """Each reader copy has the JAX module's public functions, classes
    and constants, with the same signatures."""
    import importlib
    import inspect
    j = importlib.import_module(f"fedml_tpu.data.{name}")
    t = importlib.import_module(f"fedml_tpu_torch.data.{name}")

    def public(m):
        return {k: v for k, v in vars(m).items() if not k.startswith("_")
                and getattr(v, "__module__", m.__name__) == m.__name__
                and not inspect.ismodule(v)}

    pj, pt = public(j), public(t)
    assert sorted(pj) == sorted(pt)
    for k, v in pj.items():
        if callable(v):
            assert inspect.signature(v) == inspect.signature(pt[k]), k
        elif k != "logger":
            assert v == pt[k], k


def test_readers_import_without_h5py_and_pil_and_no_jax():
    """h5py and PIL are imported inside the reader functions only, and
    nothing of the port's data package imports JAX."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = root
    out = subprocess.run([sys.executable, "-c", _NO_H5PY_PIL], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "3 segmentation []"
