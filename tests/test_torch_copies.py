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
  HTTP server). ``interceptor.py``, ``schema.py``, ``backoff.py`` and
  ``core/wire/*`` are pinned in ``tests/test_torch_comm.py`` and
  ``tests/test_torch_compression.py``.
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
