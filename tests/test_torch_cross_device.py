"""The cross-device platform of the port (``fedml_tpu_torch/cross_device``,
``native``, ``utils/paths.py``) against the JAX package's, on the CPU.

The 21 cases of ``tests/test_cross_device.py``, each run through the port
(its device server, its simulated devices on the torch or native engine,
its native core), and, where the JAX package gives a number, held to it:
sessions started from the same flax params end within the house
tolerance of the JAX session's params; the native core's outputs are the
JAX binding's bit for bit (``tests/test_torch_native.py`` holds the rest
of the core). Then what the port must give bitwise: a device fed the JAX
device's trained params uploads the JAX device's artifact, dense or
compressed (``device_wire_compression``), byte for byte, and the server
aggregates them into the JAX server's model; and a JAX server runs port
devices over TCP.
"""

from __future__ import annotations

import copy
import os
import threading

import jax
import numpy as np
import pytest
import torch

from fedml_tpu import data as jdata
from fedml_tpu import model as jmodel
from fedml_tpu import native as jnative
from fedml_tpu.arguments import Arguments as JArguments
from fedml_tpu.cross_device import run_cross_device_inproc as jrun
from fedml_tpu_torch import data as data_mod
from fedml_tpu_torch import model as model_mod
from fedml_tpu_torch import native
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.cross_device import run_cross_device_inproc
from fedml_tpu_torch.interop import flax_to_state_dict

from test_torch_comm import free_port_base
from torch_port_support import ATOL, RTOL, single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

BASE = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=3,
            client_num_per_round=3, comm_round=3, epochs=1, batch_size=32,
            learning_rate=0.1, random_seed=3, training_type="cross_device")


def make_args(**kw):
    return Arguments(**dict(BASE, **kw))


def _parts(args):
    fed, output_dim = data_mod.load(args)
    return fed, model_mod.create(args, output_dim, fed.input_shape)


def _jax_parts(**kw):
    args = JArguments(**dict(BASE, **kw))
    fed, od = jdata.load(args)
    return args, fed, jmodel.create(args, od)


def _jax_init(args, fed, bundle):
    """The JAX device server's starting model (``split(PRNGKey(seed))[0]``)
    as a state dict."""
    key = jax.random.split(jax.random.PRNGKey(int(args.random_seed)))[0]
    return flax_to_state_dict(jax.device_get(
        bundle.init(key, fed.train.x[0, 0])))


def _close(port, ref, rtol=RTOL, atol=ATOL):
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(port[k].numpy(), ref[k], rtol=rtol,
                                   atol=atol, err_msg=k)


def _session(tmp_path, sub, engines=None, **kw):
    """The port's in-proc session on the CPU from the JAX server's init,
    beside the JAX session of the same configuration."""
    jargs, jfed, jbundle = _jax_parts(
        model_file_cache_dir=str(tmp_path / f"j{sub}"), **kw)
    init = _jax_init(jargs, jfed, jbundle)
    ref = jrun(jargs, jfed, jbundle, engines=engines)
    args = make_args(model_file_cache_dir=str(tmp_path / f"t{sub}"), **kw)
    fed, bundle = _parts(args)
    got = run_cross_device_inproc(args, fed, bundle, engines=engines,
                                  device="cpu", init_params=init)
    return got, ref


def _dead_device_cls():
    from fedml_tpu_torch.cross_device import DeviceClientManager

    class DeadDevice(DeviceClientManager):
        def handle_round(self, msg):
            self.finish()  # dies before training/uploading

    return DeadDevice


def _dead_device(args, fed, bundle, device_id, eligibility=None):
    from fedml_tpu_torch.core.algframe.client_trainer import \
        make_trainer_spec
    from fedml_tpu_torch.optimizers.registry import create_optimizer
    spec = make_trainer_spec(fed, bundle)
    return _dead_device_cls()(args, fed, bundle, spec,
                              create_optimizer(args, spec),
                              device_id=device_id, backend="INPROC",
                              eligibility=eligibility, device="cpu")


def _run_server(server, devices, join_s=120):
    threads = [threading.Thread(target=d.run, daemon=True) for d in devices]
    for t in threads:
        t.start()
    done = {}

    def run_server():
        server.run()
        done["ok"] = True

    st = threading.Thread(target=run_server, daemon=True)
    st.start()
    st.join(timeout=join_s)
    assert done.get("ok"), "server stalled"
    return server


# --- tests/test_cross_device.py's cases ------------------------------------

def test_three_devices_complete_rounds(tmp_path):
    got, ref = _session(tmp_path, "a")
    assert got is not None
    assert len(got["history"]) == 3
    assert got["final_test_acc"] > 0.5, got["history"]
    _close(got["params"], flax_to_state_dict(jax.device_get(ref["params"])))
    assert len(got["round_times"]) == 3


def test_native_engine_device_session(tmp_path):
    """One device trains in the C++ core, two on the torch engine — the
    server aggregates both interchangeably (the MobileNN story); the
    session ends within the house tolerance of the JAX one's."""
    got, ref = _session(tmp_path, "n", engines=["native", None, None],
                        learning_rate=0.2)
    assert len(got["history"]) == 3
    assert got["final_test_acc"] > 0.5, got["history"]
    accs = [r["device_eval_acc"] for r in got["history"]
            if "device_eval_acc" in r]
    assert len(accs) == 3, got["history"]
    assert all(0.0 <= a <= 1.0 for a in accs)
    assert accs[-1] > accs[0], accs  # global model improved across rounds
    _close(got["params"], flax_to_state_dict(jax.device_get(ref["params"])))


class TestNativeCore:
    def test_native_trainer_learns_real_digits(self):
        from sklearn.datasets import load_digits
        ds = load_digits()
        x = (ds.data / 16.0).astype(np.float32)
        y = ds.target
        params = {"Dense_0": {"kernel": np.zeros((64, 10), np.float32),
                              "bias": np.zeros(10, np.float32)}}
        p, loss = native.NativeLinearTrainer().train(
            copy.deepcopy(params), x[:1500], y[:1500], epochs=5,
            batch_size=32, lr=0.3, seed=1)
        t = native.NativeLinearTrainer()
        assert t.evaluate(p, x[1500:], y[1500:]) > 0.85
        assert loss < 0.6
        jp, jloss = jnative.NativeLinearTrainer().train(
            copy.deepcopy(params), x[:1500], y[:1500], epochs=5,
            batch_size=32, lr=0.3, seed=1)
        assert loss == jloss
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(p["Dense_0"][k], jp["Dense_0"][k])

    def test_native_gradient_matches_numpy(self):
        """One full-batch step of the C++ trainer equals the analytic
        softmax-regression gradient step."""
        rs = np.random.RandomState(0)
        x = rs.randn(8, 5).astype(np.float32)
        y = rs.randint(0, 3, 8).astype(np.int64)
        W0 = rs.randn(5, 3).astype(np.float32) * 0.1
        b0 = rs.randn(3).astype(np.float32) * 0.1
        lr = 0.5
        t = native.NativeLinearTrainer()
        p, _ = t.train({"Dense_0": {"kernel": W0.copy(), "bias": b0.copy()}},
                       x, y, epochs=1, batch_size=8, lr=lr, seed=0)
        logits = x @ W0 + b0
        e = np.exp(logits - logits.max(1, keepdims=True))
        probs = e / e.sum(1, keepdims=True)
        dl = probs - np.eye(3)[y]
        gW = x.T @ dl / len(x)
        gb = dl.mean(0)
        np.testing.assert_allclose(p["Dense_0"]["kernel"], W0 - lr * gW,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(p["Dense_0"]["bias"], b0 - lr * gb,
                                   rtol=1e-4, atol=1e-5)

    def test_native_mask_sums_cancel(self):
        """LightSecAgg shape: sum of masked vectors minus sum of masks
        reconstructs the sum of updates (field arithmetic mod 2^31-1)."""
        scale = 65536.0
        rs = np.random.RandomState(1)
        vs = [rs.randn(500).astype(np.float32) for _ in range(3)]
        seeds = [11, 22, 33]
        masked = [native.mask_vector(v, scale, s)
                  for v, s in zip(vs, seeds)]
        for m, v, s in zip(masked, vs, seeds):
            np.testing.assert_array_equal(m, jnative.mask_vector(v, scale, s))
        p = native.PRIME
        agg = np.zeros(500, np.uint64)
        for m in masked:
            agg = (agg + m) % p
        for s in seeds:
            agg = (agg + p - native.gen_mask(500, s)) % p
        half = p // 2
        agg = (agg + p - (3 * half) % p) % p
        signed = np.where(agg > half, agg.astype(np.int64) - p,
                          agg.astype(np.int64))
        recovered = signed.astype(np.float64) / scale
        np.testing.assert_allclose(recovered, sum(vs), atol=1e-3)


def test_dead_device_does_not_stall_round(tmp_path):
    """Elastic rounds: a device that dies after registration must not
    hang the all-received barrier — the round aggregates the
    reporters."""
    from fedml_tpu_torch.core.distributed.communication.inproc import \
        InProcBroker
    from fedml_tpu_torch.cross_device import (build_device_client,
                                              build_device_server)
    args = make_args(comm_round=2, round_timeout_s=12.0,
                     model_file_cache_dir=str(tmp_path))
    fed, bundle = _parts(args)
    args.inproc_broker = InProcBroker()
    server = build_device_server(args, fed, bundle, backend="INPROC",
                                 device="cpu")
    devices = [build_device_client(args, fed, copy.deepcopy(bundle),
                                   device_id=i, backend="INPROC",
                                   device="cpu") for i in (1, 2)]
    devices.append(_dead_device(args, fed, copy.deepcopy(bundle), 3))
    _run_server(server, devices)
    assert len(server.result["history"]) == 2
    assert server.result["final_test_acc"] > 0.5


class TestCohortAssembly:
    """Streaming cohort assembly on the device server: eligibility
    predicates from the registration handshake, pacer-driven deadlines,
    and chaos (a dead cohort member) + selection on the same rounds."""

    def _session(self, tmp_path, n_devices, dead=(), eligibility=None,
                 **kw):
        from fedml_tpu_torch.core.distributed.communication.inproc import \
            InProcBroker
        from fedml_tpu_torch.cross_device import (build_device_client,
                                                  build_device_server)
        args = make_args(model_file_cache_dir=str(tmp_path),
                         client_num_in_total=n_devices,
                         client_num_per_round=n_devices,
                         cohort_assembly=True, **kw)
        args.inproc_broker = InProcBroker()
        fed, bundle = _parts(args)
        server = build_device_server(args, fed, bundle, backend="INPROC",
                                     device="cpu")
        eligs = eligibility or [None] * n_devices
        devices = []
        for i in range(1, n_devices + 1):
            if i in dead:
                devices.append(_dead_device(args, fed, copy.deepcopy(bundle),
                                            i, eligs[i - 1]))
            else:
                devices.append(build_device_client(
                    args, fed, copy.deepcopy(bundle), device_id=i,
                    backend="INPROC", eligibility=eligs[i - 1],
                    device="cpu"))
        return _run_server(server, devices)

    def test_eligibility_filters_cohort(self, tmp_path):
        server = self._session(
            tmp_path, n_devices=3, comm_round=3, cohort_size=2,
            cohort_require_charging=True,
            eligibility=[None, {"charging": False}, None])
        assert len(server.result["history"]) == 3
        assert server.result["final_test_acc"] > 0.5
        sel = server.stats.times_selected_for([1, 2, 3])
        assert sel[1] == 0 and sel[0] == 3 and sel[2] == 3
        assert server.pacer.deadline_s <= 60.0
        assert float(np.sum(server.stats.dropout_posterior_mean([2]))) \
            < 0.1

    def test_chaos_plus_selection_pacer_adapts(self, tmp_path):
        server = self._session(
            tmp_path, n_devices=3, dead={3}, comm_round=2,
            pacer_deadline_s=2.0, pacer_target_frac=0.9)
        assert len(server.result["history"]) == 2
        assert server.result["final_test_acc"] > 0.5
        assert server.pacer.deadline_s > 2.0
        assert server.pacer.over_sample > 1.3
        assert server.pacer.rounds_observed == 2
        assert server.stats.dropout_posterior_mean([3])[0] > \
            server.stats.dropout_posterior_mean([1])[0]
        assert np.all(np.isfinite(server.stats.latency_for([1, 2])))

    def test_reregister_is_idempotent(self, tmp_path):
        from fedml_tpu_torch.core.distributed.communication.inproc import \
            InProcBroker
        from fedml_tpu_torch.core.distributed.communication.message import \
            Message
        from fedml_tpu_torch.cross_device import build_device_server
        from fedml_tpu_torch.cross_device.message_define import \
            DeviceMessage
        args = make_args(model_file_cache_dir=str(tmp_path),
                         client_num_in_total=2, client_num_per_round=2,
                         cohort_assembly=True,
                         fleet_registry=str(tmp_path / "fleet.db"))
        args.inproc_broker = InProcBroker()
        fed, bundle = _parts(args)
        server = build_device_server(args, fed, bundle, backend="INPROC",
                                     device="cpu")
        server.stats.record_availability(1, participated=True)

        def reg_msg(did, charging=True):
            msg = Message(DeviceMessage.MSG_TYPE_D2S_REGISTER, did, 0)
            msg.add_params(DeviceMessage.ARG_DEVICE_ID, did)
            msg.add_params(DeviceMessage.ARG_DEVICE_OS, "test")
            msg.add_params(DeviceMessage.ARG_DEVICE_ENGINE, "torch")
            msg.add_params(DeviceMessage.ARG_DEVICE_CHARGING, charging)
            return msg

        server.handle_register(reg_msg(1, charging=True))
        server.handle_register(reg_msg(1, charging=False))  # flap
        assert len(server.devices_online) == 1
        assert server.devices_online[1]["charging"] is False
        assert not server.is_initialized
        row = server.fleet.device(1)
        assert server.fleet.device_count() == 1
        assert row["registrations"] == 2
        assert row["charging"] is False
        assert float(server.stats.dropout_posterior_mean([1])[0]) < 0.5

    def test_cohort_off_is_legacy_path(self, tmp_path):
        from fedml_tpu_torch.cross_device.runner import build_device_server
        args = make_args(model_file_cache_dir=str(tmp_path))
        fed, bundle = _parts(args)
        result = run_cross_device_inproc(args, fed, bundle, device="cpu")
        assert len(result["history"]) == 3
        server = build_device_server(args, fed, bundle, backend="INPROC",
                                     device="cpu")
        assert not server.cohort_enabled
        assert server.stats is None and server.pacer is None


def test_artifact_codec_is_not_pickle(tmp_path):
    """Model artifacts are msgpack (magic-checked), never pickled, and
    the port writes the JAX package's bytes for the same params."""
    import pickle

    from fedml_tpu.serving import save_model as jsave
    from fedml_tpu_torch.serving import load_model, save_model
    params = {"dense": {"kernel": np.ones((3, 2), np.float32),
                        "bias": np.zeros((2,), np.float32)}}
    path, jpath = str(tmp_path / "m.npk"), str(tmp_path / "j.npk")
    save_model(params, path)
    jsave(params, jpath)
    with open(path, "rb") as f, open(jpath, "rb") as g:
        blob = f.read()
        assert blob == g.read()
    assert blob[:6] == b"FMTPU1"
    back = load_model(path)
    np.testing.assert_array_equal(back["dense"]["kernel"],
                                  params["dense"]["kernel"])
    evil = str(tmp_path / "evil.npk")
    with open(evil, "wb") as f:
        pickle.dump({"x": 1}, f)
    with pytest.raises(ValueError, match="bad magic"):
        load_model(evil)


def test_peer_path_confinement(tmp_path):
    from fedml_tpu_torch.utils.paths import confine_path
    root = tmp_path / "cache"
    root.mkdir()
    inside = root / "ok.npk"
    inside.write_bytes(b"x")
    assert confine_path(str(inside), str(root))
    for bad in ("/etc/passwd", str(root / ".." / "escape.npk"),
                str(tmp_path / "other.npk")):
        with pytest.raises(ValueError, match="escapes"):
            confine_path(bad, str(root))


def test_dead_round_leash_zero_arrivals(tmp_path):
    """If NO device reports in a round, the 3x leash armed at dispatch
    closes the round with the previous global model."""
    import time

    from fedml_tpu_torch.core.distributed.communication.inproc import \
        InProcBroker
    from fedml_tpu_torch.cross_device.runner import build_device_server
    args = make_args(model_file_cache_dir=str(tmp_path), comm_round=2,
                     client_num_per_round=1, round_timeout_s=0.3)
    args.inproc_broker = InProcBroker()
    fed, bundle = _parts(args)
    server = build_device_server(args, fed, bundle, backend="INPROC",
                                 device="cpu")
    server.send_message = lambda msg: None   # devices never hear dispatch
    server.finish = lambda: None
    server.devices_online[1] = {"os": "?", "engine": "?"}
    before = {k: v.clone() for k, v in
              server.aggregator.global_params.items()}
    server.is_initialized = True
    server._dispatch_round("init")           # arms the 3x leash
    deadline = time.time() + 10
    while server.round_idx < 2 and time.time() < deadline:
        time.sleep(0.05)
    assert server.round_idx >= 2, "dead rounds did not advance"
    for k, v in server.aggregator.global_params.items():
        assert torch.equal(v, before[k])


class TestNativeCNN:
    """The native LeNet-class engine (train_cnn_sgd) against the port's
    DeviceCNN: full-batch step parity, learning on real digits, and a
    mixed native + torch federated session."""

    def _digits(self):
        from sklearn.datasets import load_digits
        ds = load_digits()
        x = (ds.images / 16.0).astype(np.float32)[..., None]  # [n, 8, 8, 1]
        return x, ds.target.astype(np.int32)

    def _init_params(self, output_dim=10):
        """The JAX DeviceCNN's init (flax tree) and the port's bundle."""
        jargs = JArguments(**dict(BASE, model="device_cnn"))
        jb = jmodel.create(jargs, output_dim)
        params = jax.device_get(jb.init(jax.random.PRNGKey(0),
                                        np.zeros((1, 8, 8, 1), np.float32)))
        bundle = model_mod.create(make_args(model="device_cnn"), output_dim,
                                  (8, 8, 1))
        return bundle, params

    def test_native_cnn_fullbatch_gradients_match_torch(self):
        """One full-batch step at lr=1 recovers the native gradient; it
        equals the port's DeviceCNN gradient to float tolerance, and the
        step equals the JAX binding's bitwise."""
        bundle, params = self._init_params()
        x, y = self._digits()
        x, y = x[:8], y[:8]
        nat, _ = native.NativeCNNTrainer().train(
            jax.tree_util.tree_map(np.copy, params), x, y, epochs=1,
            batch_size=len(x), lr=1.0, seed=0)
        jnat, _ = jnative.NativeCNNTrainer().train(
            jax.tree_util.tree_map(np.copy, params), x, y, epochs=1,
            batch_size=len(x), lr=1.0, seed=0)
        sd = {k: torch.tensor(v).requires_grad_()
              for k, v in flax_to_state_dict(params).items()}
        logits = bundle.apply(sd, torch.from_numpy(x))
        loss = torch.nn.functional.cross_entropy(
            logits, torch.from_numpy(y).long())
        grads = dict(zip(sd, torch.autograd.grad(loss, list(sd.values()))))
        g_nat = flax_to_state_dict(jax.tree_util.tree_map(
            lambda a, b: np.asarray(a) - np.asarray(b), params, nat))
        for k, g in grads.items():
            np.testing.assert_allclose(g_nat[k], g.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        for a, b in zip(jax.tree_util.tree_leaves(nat),
                        jax.tree_util.tree_leaves(jnat)):
            np.testing.assert_array_equal(a, b)

    def test_native_cnn_learns_real_digits(self):
        _, params = self._init_params()
        x, y = self._digits()
        t = native.NativeCNNTrainer()
        params, loss = t.train(params, x[:1400], y[:1400], epochs=6,
                               batch_size=32, lr=0.1, seed=1)
        acc = t.evaluate(params, x[1400:], y[1400:])
        assert acc > 0.85, (acc, loss)

    def test_mixed_native_torch_cnn_federation(self, tmp_path):
        """One native-CNN device + two torch devices train digits
        federated: the server aggregates their updates interchangeably."""
        args = make_args(model="device_cnn", dataset="digits",
                         comm_round=4, learning_rate=0.2,
                         model_file_cache_dir=str(tmp_path))
        fed, bundle = _parts(args)
        result = run_cross_device_inproc(args, fed, bundle,
                                         engines=["native", None, None],
                                         device="cpu")
        assert result is not None
        assert result["final_test_acc"] > 0.7, result["history"]


class TestNativeLSAandReader:
    def test_native_lsa_encode_decodes_with_python_pipeline(self):
        """Native Lagrange-coded sub-masks from several devices decode to
        the exact aggregate mask with the port's server math."""
        from fedml_tpu_torch.core.mpc.lightsecagg import \
            decode_aggregate_mask
        P = native.PRIME
        n, privacy_t, split_t, d = 4, 1, 2, 12
        rng = np.random.RandomState(0)
        zs = [rng.randint(0, P, size=d).astype(np.uint32) for _ in range(n)]
        encs = [native.lsa_mask_encode(z, n, privacy_t, split_t, seed=50 + i)
                for i, z in enumerate(zs)]
        for i, (z, e) in enumerate(zip(zs, encs)):
            np.testing.assert_array_equal(
                e, jnative.lsa_mask_encode(z, n, privacy_t, split_t,
                                           seed=50 + i))
        responses = []
        for j in range(n):
            acc = np.zeros(d // split_t, np.uint64)
            for i in range(n):
                acc = (acc + encs[i][j].astype(np.uint64)) % P
            responses.append(acc)
        need = split_t + privacy_t
        z_sum = decode_aggregate_mask(responses[:need], list(range(need)),
                                      n, privacy_t, split_t, d)
        want = np.zeros(d, np.uint64)
        for z in zs:
            want = (want + z.astype(np.uint64)) % P
        np.testing.assert_array_equal(np.asarray(z_sum, np.uint64) % P, want)

    def test_native_csv_reader(self, tmp_path):
        rng = np.random.RandomState(1)
        x = rng.randn(17, 5).astype(np.float32)
        y = rng.randint(0, 3, size=17)
        path = tmp_path / "data.csv"
        with open(path, "w") as f:
            for xi, yi in zip(x, y):
                f.write(",".join(f"{v:.6f}" for v in xi) + f",{yi}\n")
        rx, ry = native.read_csv(str(path))
        np.testing.assert_allclose(rx, x, atol=1e-5)
        np.testing.assert_array_equal(ry, y)


class TestNativeArtifactAndClientManager:
    """Native serialized-model handling + the FedMLClientManager-analogue
    session: the device consumes the server's global model artifact and
    produces a server-loadable update with no Python codec."""

    @staticmethod
    def _digits_artifact(tmp_path):
        from sklearn import datasets as skd

        from fedml_tpu_torch.serving import save_model
        ds = skd.load_digits()
        x = np.asarray(ds.data, np.float32) / 16.0
        y = np.asarray(ds.target, np.int64)
        bundle = model_mod.create(make_args(), 10, (64,))
        params = bundle.init(torch.Generator().manual_seed(0), "cpu")
        path = str(tmp_path / "global.fmtpu")
        save_model(params, path)
        return path, x, y, bundle, params

    def test_artifact_roundtrip_native_vs_python(self, tmp_path):
        from fedml_tpu_torch.serving import load_model
        path, *_ = self._digits_artifact(tmp_path)
        leaves = native.load_artifact_native(path)
        py = load_model(path)
        assert set(leaves) == {"Dense_0/kernel", "Dense_0/bias"}
        np.testing.assert_array_equal(leaves["Dense_0/kernel"],
                                      np.asarray(py["Dense_0"]["kernel"]))
        out, jout = str(tmp_path / "native.fmtpu"), str(tmp_path / "j.fmtpu")
        native.save_artifact_native(leaves, out)
        jnative.save_artifact_native(leaves, jout)
        with open(out, "rb") as f, open(jout, "rb") as g:
            assert f.read() == g.read()
        py2 = load_model(out)
        np.testing.assert_array_equal(np.asarray(py2["Dense_0"]["bias"]),
                                      leaves["Dense_0/bias"])

    def test_client_manager_trains_and_reports_accuracy(self, tmp_path):
        from fedml_tpu_torch.serving import load_model
        path, x, y, bundle, params = self._digits_artifact(tmp_path)
        csv = str(tmp_path / "shard.csv")
        with open(csv, "w") as f:
            for xi, yi in zip(x[:800], y[:800]):
                f.write(",".join(f"{v:.6f}" for v in xi) + f",{yi}\n")
        losses, progress = [], []
        with native.NativeClientManager() as cm:
            cm.init(path, csv, batch_size=32, learning_rate=0.3, epochs=4,
                    seed=7)
            cm.set_callbacks(on_progress=progress.append,
                             on_loss=lambda e, l: losses.append((e, l)))
            acc0 = cm.evaluate()
            final_loss = cm.train()
            e, l = cm.get_epoch_and_loss()
            acc1 = cm.evaluate()
            out = str(tmp_path / "update.fmtpu")
            cm.save_model(out)
        assert e == 3 and abs(l - final_loss) < 1e-6
        assert len(losses) == 4 and progress[-1] == 100.0
        assert losses[0][1] > losses[-1][1]
        assert acc0 < 0.3 and acc1 > 0.8, (acc0, acc1)
        trained = load_model(out)
        assert not np.allclose(np.asarray(trained["Dense_0"]["kernel"]),
                               params["Dense_0.weight"].numpy().T)

    def test_stop_training_interrupts(self, tmp_path):
        path, x, y, *_ = self._digits_artifact(tmp_path)
        csv = str(tmp_path / "shard.csv")
        with open(csv, "w") as f:
            for xi, yi in zip(x[:200], y[:200]):
                f.write(",".join(f"{v:.6f}" for v in xi) + f",{yi}\n")
        with native.NativeClientManager() as cm:
            cm.init(path, csv, epochs=50)
            cm.set_callbacks(
                on_loss=lambda e, l: cm.stop_training() if e == 1 else None)
            cm.train()
            e, _ = cm.get_epoch_and_loss()
        assert e <= 2


# --- the port against the JAX package, bit for bit -------------------------


def _artifacts(root):
    out = {}
    for name in sorted(os.listdir(root)):
        if name.startswith("device_"):
            with open(os.path.join(root, name), "rb") as f:
                out[name] = f.read()
    return out


@pytest.mark.parametrize("wire", [{}, {"device_wire_compression":
                                       "topk_qsgd",
                                       "comm_compression_ratio": 0.1}])
def test_uploads_and_aggregate_equal_reference_bitwise(tmp_path,
                                                       monkeypatch, wire):
    """Port devices handed the JAX devices' trained params (read from a
    dense JAX session's uploads) upload the JAX devices' artifacts byte
    for byte, dense or compressed with the same error-feedback key, and
    the port's server aggregates them into the JAX server's model
    bitwise (float32, sorted device order, weight n / Σn)."""
    from fedml_tpu_torch.cross_device.client import DeviceClientManager
    from fedml_tpu_torch.serving import load_model
    jargs, jfed, jbundle = _jax_parts(
        comm_round=1, model_file_cache_dir=str(tmp_path / "jd"))
    init = _jax_init(jargs, jfed, jbundle)
    jrun(jargs, jfed, jbundle)                        # the trained params
    ja2, jf2, jb2 = _jax_parts(
        comm_round=1, model_file_cache_dir=str(tmp_path / "j"), **wire)
    ref = jrun(ja2, jf2, jb2)
    dense = str(tmp_path / "jd")

    def train(self, params, cid, round_idx):
        trained = load_model(os.path.join(
            dense, f"device_{self.device_id}_round_{round_idx}.npk"))
        return ({k: torch.tensor(v) for k, v in
                 flax_to_state_dict(trained).items()},
                float(np.asarray(self.fed.train.num_samples)[cid]), 0.0)

    monkeypatch.setattr(DeviceClientManager, "_train_torch", train)
    args = make_args(comm_round=1, model_file_cache_dir=str(tmp_path / "t"),
                     **wire)
    fed, bundle = _parts(args)
    got = run_cross_device_inproc(args, fed, bundle, device="cpu",
                                  init_params=init)
    assert _artifacts(tmp_path / "t") == _artifacts(tmp_path / "j")
    want = flax_to_state_dict(jax.device_get(ref["params"]))
    for k, v in got["params"].items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_compressed_session_matches_reference(tmp_path):
    """``device_wire_compression: topk_qsgd`` for 1 round, trained by each
    package. The trainings differ by float32 rounding (~1e-8), and that
    can move an entry across a quantization level or a top-k tie (the
    known limit of compressed sessions): at most 1 % of the entries may
    leave the house tolerance, and none by more than one level of one
    device's blob (``s / L`` at its weight) beyond it. The blobs
    themselves are held bitwise above."""
    from fedml_tpu_torch.serving import load_model
    got, ref = _session(tmp_path, "c", comm_round=1,
                        device_wire_compression="topk_qsgd",
                        comm_compression_ratio=0.1)
    want = flax_to_state_dict(jax.device_get(ref["params"]))
    root = tmp_path / "jc"
    blobs = [load_model(str(root / f"device_{i}_round_0.npk"))
             for i in (1, 2, 3)]
    n = np.asarray(jdata.load(JArguments(**BASE))[0].client_num_samples,
                   np.float64)
    quantum = max(float(b["s"]) / int(b["L"]) * w
                  for b, w in zip(blobs, n / n.sum()))
    out, total = 0, 0
    for k, v in got["params"].items():
        diff = np.abs(v.numpy() - want[k])
        tol = ATOL + RTOL * np.abs(want[k])
        out += int(np.sum(diff > tol))
        total += diff.size
        assert np.all(diff <= tol + quantum), k
    assert out <= 0.01 * total, (out, total)


def test_jax_server_with_port_devices_over_tcp(tmp_path):
    """A JAX device server with three port devices on the torch engine
    over TCP on loopback: the session ends within the house tolerance of
    the all-JAX session."""
    from fedml_tpu.cross_device import build_device_server as jserver
    from fedml_tpu_torch.cross_device import build_device_client
    ref_args, jfed, jbundle = _jax_parts(
        model_file_cache_dir=str(tmp_path / "ref"))
    ref = jrun(ref_args, jfed, jbundle)
    base = free_port_base(4)
    cache = str(tmp_path / "mixed")
    jargs, _, _ = _jax_parts(model_file_cache_dir=cache, backend="TCP",
                             tcp_base_port=base)
    server = jserver(jargs, jfed, jbundle, backend="TCP")
    args = make_args(model_file_cache_dir=cache, backend="TCP",
                     tcp_base_port=base)
    fed, bundle = _parts(args)
    devices = [build_device_client(args, fed, copy.deepcopy(bundle),
                                   device_id=i, backend="TCP", device="cpu")
               for i in (1, 2, 3)]
    _run_server(server, devices)
    assert len(server.result["history"]) == 3
    got = flax_to_state_dict(jax.device_get(server.result["params"]))
    _close({k: torch.tensor(v) for k, v in got.items()},
           flax_to_state_dict(jax.device_get(ref["params"])))
    assert {d["engine"] for d in server.devices_online.values()} == \
        {"torch"}


def test_entry_point_and_engine_names(tmp_path):
    """``training_type: cross_device`` runs through the port's
    ``FedMLRunner`` (a device process per role), ``device_engine: jax``
    names the torch engine, an unknown engine raises, and without CUDA
    and without ``device="cpu"`` the runner refuses."""
    from fedml_tpu_torch.core.distributed.communication.inproc import \
        InProcBroker
    from fedml_tpu_torch.cross_device.client import engine_name
    from fedml_tpu_torch.runner import FedMLRunner
    assert engine_name("jax") == engine_name("torch") == "torch"
    assert engine_name("native") == "native"
    with pytest.raises(ValueError, match="device_engine"):
        engine_name("mnn")
    args = make_args(model_file_cache_dir=str(tmp_path), comm_round=1,
                     client_num_in_total=1, client_num_per_round=1,
                     device_engine="jax", backend="INPROC")
    args.inproc_broker = InProcBroker()
    fed, bundle = _parts(args)
    server = FedMLRunner(args, device="cpu", dataset=fed, model=bundle)
    dev_args = copy.copy(args)
    dev_args.role, dev_args.rank = "device", 1
    device = FedMLRunner(dev_args, device="cpu", dataset=fed,
                         model=copy.deepcopy(bundle))
    assert device.runner.manager.engine == "torch"
    t = threading.Thread(target=device.run, daemon=True)
    t.start()
    result = server.run()
    t.join(timeout=10)
    assert len(result["history"]) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            FedMLRunner(args, dataset=fed, model=bundle)
