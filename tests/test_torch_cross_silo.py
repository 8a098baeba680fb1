"""The port's cross-silo runtime against the JAX package's.

The session of the JAX package's ``tests/test_cross_silo.py`` (synthetic
MNIST, LR, 4 silos, all in every round, lr 0.1, seed 9), the JAX init
carried across (``interop.flax_to_state_dict``), house tolerance:

* the port's in-proc session equals the JAX in-proc session (dense; a
  bf16 broadcast with ``randk_qsgd`` uplinks; FedProx);
* with ``topk_qsgd`` and the compressed broadcast: one round equals the
  JAX session's, and over three rounds every blob the port's silos and
  server send equals the JAX package's ``ef_compress_vec`` of the same
  inputs bit for bit (end to end, a float32 difference in the aggregate
  reorders near-tied magnitudes in the broadcast's top-k, so the three
  rounds are held blob by blob);
* the port's session equals the port's SP golden loop (the JAX package's
  ``test_cross_silo_matches_sp_golden`` tolerance);
* mixed sessions over TCP on loopback, a JAX server with port silos and a
  port server with JAX silos, end at the all-JAX session's params; the
  port over TCP and over gRPC equal its INPROC session bitwise;
* a dead silo under ``round_timeout_s``, a seeded dropout session (and
  a round every silo drops out of, skipped) and a link-fault session each
  complete; the wire checkpoint's resume equals an uninterrupted
  client's uplinks;
* the entry points, and the refusals of what is not ported (the
  buffered-async server is ported: ``test_torch_async_cross_silo.py``).
"""

from __future__ import annotations

import copy
import threading
import types

import jax
import numpy as np
import pytest
import torch

from fedml_tpu import data as jdata
from fedml_tpu import model as jmodel
from fedml_tpu.arguments import Arguments as JArgs
from fedml_tpu.cross_silo.horizontal import runner as JR
import fedml_tpu_torch
from fedml_tpu_torch import data as tdata
from fedml_tpu_torch import model as tmodel
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.cross_silo.horizontal import runner as TR
from fedml_tpu_torch.interop import flax_to_state_dict

from test_torch_comm import free_port_base
from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
SESSION = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=4,
               client_num_per_round=4, comm_round=3, epochs=1, batch_size=32,
               learning_rate=0.1, frequency_of_the_test=1, random_seed=9,
               training_type="cross_silo", enable_tracking=False)
JOIN_S = 120.0


def _jax_parts(cfg):
    args = JArgs(**cfg)
    fed, od = jdata.load(args)
    return args, fed, jmodel.create(args, od)


def _port_parts(cfg):
    args = Arguments(**cfg)
    fed, od = tdata.load(args)
    return args, fed, tmodel.create(args, od, fed.input_shape)


def _jax_init(cfg):
    args, fed, bundle = _jax_parts(cfg)
    key = jax.random.split(jax.random.PRNGKey(cfg["random_seed"]))[0]
    return flax_to_state_dict(jax.device_get(bundle.init(key,
                                                         fed.train.x[0, 0])))


def _jax_params(result):
    return flax_to_state_dict(jax.device_get(result["params"]))


def _close(port, ref, rtol=RTOL, atol=ATOL):
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(
            port[k].detach().cpu().numpy() if torch.is_tensor(port[k])
            else port[k], ref[k], rtol=rtol, atol=atol, err_msg=k)


def _run(server, clients, join_s=JOIN_S):
    """Silos and server on threads; the server must finish in time."""
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()
    st = threading.Thread(target=server.run, daemon=True)
    st.start()
    st.join(timeout=join_s)
    assert not st.is_alive(), "the session stalled"
    for c, t in zip(clients, threads):
        t.join(timeout=5)
        if t.is_alive():        # a lost FINISH leaves a silo waiting
            c.finish()
    return server.result


def _port_session(cfg, init, backend="INPROC", **extra):
    args, fed, bundle = _port_parts(dict(cfg, **extra))
    n = args.client_num_per_round
    if backend == "INPROC":
        from fedml_tpu_torch.core.distributed.communication.inproc import \
            InProcBroker
        args.inproc_broker = InProcBroker()
    else:
        args.tcp_base_port = args.grpc_base_port = free_port_base(n + 1)
    server = TR.build_server(args, fed, bundle, backend=backend,
                             device="cpu", init_params=init)
    clients = [TR.build_client(args, fed, copy.deepcopy(bundle), rank=r,
                               backend=backend, device="cpu")
               for r in range(1, n + 1)]
    return _run(server, clients), server, clients


@pytest.fixture(scope="module")
def jax_session():
    """The all-JAX in-proc session and its init, once per module."""
    args, fed, bundle = _jax_parts(SESSION)
    return JR.run_cross_silo_inproc(args, fed, bundle), _jax_init(SESSION)


def test_inproc_session_matches_jax(jax_session):
    ref, init = jax_session
    got, _, _ = _port_session(SESSION, init)
    _close(got["params"], _jax_params(ref))
    assert [h["wire_bytes"] for h in got["history"]] == \
        [h["wire_bytes"] for h in ref["history"]]
    assert [h["test_acc"] for h in got["history"]] == \
        [h["test_acc"] for h in ref["history"]]
    assert got["rounds"] == ref["rounds"] == 3


@pytest.mark.parametrize("knobs", [
    dict(comm_compression="randk_qsgd", comm_compression_ratio=0.1,
         comm_compression_broadcast="bf16"),
    dict(federated_optimizer="FedProx", fedprox_mu=0.1)],
    ids=["bf16_broadcast_randk_qsgd", "fedprox"])
def test_session_variant_matches_jax(knobs):
    """A bf16 broadcast with ``randk_qsgd`` uplinks; FedProx's proximal
    transform inside each silo's step program."""
    cfg = dict(SESSION, **knobs)
    args, fed, bundle = _jax_parts(cfg)
    ref = JR.run_cross_silo_inproc(args, fed, bundle)
    got, _, _ = _port_session(cfg, _jax_init(cfg))
    _close(got["params"], _jax_params(ref))
    assert [h["wire_bytes"] for h in got["history"]] == \
        [h["wire_bytes"] for h in ref["history"]]


TOPK_QSGD = dict(comm_compression="topk_qsgd", comm_compression_ratio=0.05,
                 comm_compression_broadcast="compress")


def test_topk_qsgd_compressed_broadcast_one_round_matches_jax():
    cfg = dict(SESSION, comm_round=1, **TOPK_QSGD)
    args, fed, bundle = _jax_parts(cfg)
    ref = JR.run_cross_silo_inproc(args, fed, bundle)
    got, _, _ = _port_session(cfg, _jax_init(cfg))
    _close(got["params"], _jax_params(ref))
    assert [h["wire_bytes"] for h in got["history"]] == \
        [h["wire_bytes"] for h in ref["history"]]


def test_topk_qsgd_compressed_broadcast_blobs_match_jax(monkeypatch):
    """Three rounds: every uplink and broadcast blob (and the residual it
    leaves) equals the JAX package's ``ef_compress_vec`` of the same
    vector, residual and key, bit for bit."""
    from fedml_tpu.utils import compression as J
    from fedml_tpu_torch.cross_silo.client import \
        fedml_client_master_manager as tc
    from fedml_tpu_torch.cross_silo.server import fedml_server_manager as ts
    from fedml_tpu_torch.utils import compression as T
    calls, lock = [], threading.Lock()
    orig = T.ef_compress_vec

    def spy(vec, residual, spec, rng):
        blob, res = orig(vec, residual, spec, rng)
        with lock:
            calls.append((np.array(vec, np.float32, copy=True),
                          None if residual is None else
                          np.array(residual, np.float32, copy=True),
                          spec, np.array(rng), blob, res))
        return blob, res

    monkeypatch.setattr("fedml_tpu_torch.core.wire.pipeline.ef_compress_vec",
                        spy)
    assert tc.encode_update is ts.encode_update
    cfg = dict(SESSION, **TOPK_QSGD)
    got, server, _ = _port_session(cfg, _jax_init(cfg))
    assert len(got["history"]) == 3
    # 4 uplinks a round, a compressed broadcast in rounds 1 and 2
    assert len(calls) == 4 * 3 + 2
    for vec, res, spec, rng, blob, new_res in calls:
        jspec = J.CommCompressionSpec(method=spec.method, ratio=spec.ratio,
                                      levels=spec.levels,
                                      broadcast=spec.broadcast)
        jb, jr = J.ef_compress_vec(vec, res, jspec,
                                   jax.numpy.asarray(rng, jax.numpy.uint32))
        assert sorted(jb) == sorted(blob)
        for k in jb:
            assert np.asarray(jb[k]).tobytes() == \
                np.asarray(blob[k]).tobytes(), k
        assert np.asarray(jr).tobytes() == new_res.tobytes()


def test_session_matches_sp_golden():
    """Full participation, plain SGD: the WAN FSM's global model equals
    the SP golden loop's (the JAX package's tolerance for the same
    check)."""
    cfg = dict(SESSION, comm_round=2)
    init = _jax_init(cfg)
    got, _, _ = _port_session(cfg, init)
    sp = dict(cfg, training_type="simulation")
    r = fedml_tpu_torch.run_simulation(backend="sp", device="cpu",
                                       init_params=init, **sp)
    _close(got["params"], {k: v.numpy() for k, v in r["params"].items()},
           rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("server_side", ["jax", "port"])
def test_mixed_session_over_tcp(jax_session, server_side):
    """A JAX server with port silos, and a port server with JAX silos,
    over TCP on loopback: both end at the all-JAX session's params."""
    ref, init = jax_session
    base = free_port_base(5)
    cfg = dict(SESSION, tcp_base_port=base)
    jargs, jfed, jbundle = _jax_parts(cfg)
    targs, tfed, tbundle = _port_parts(cfg)
    if server_side == "jax":
        server = JR.build_server(jargs, jfed, jbundle, backend="TCP")
        clients = [TR.build_client(targs, tfed, copy.deepcopy(tbundle),
                                   rank=r, backend="TCP", device="cpu")
                   for r in range(1, 5)]
    else:
        server = TR.build_server(targs, tfed, tbundle, backend="TCP",
                                 device="cpu", init_params=init)
        clients = [JR.build_client(jargs, jfed, jbundle, rank=r,
                                   backend="TCP") for r in range(1, 5)]
    got = _run(server, clients)
    params = (_jax_params(got) if server_side == "jax" else
              {k: v.numpy() for k, v in got["params"].items()})
    _close(params, _jax_params(ref))
    assert len(got["history"]) == 3


@pytest.mark.parametrize("backend", ["TCP", "GRPC"])
def test_transport_sessions_equal_inproc_bitwise(jax_session, backend):
    if backend == "GRPC":
        pytest.importorskip("grpc")
    _, init = jax_session
    cfg = dict(SESSION, comm_round=2)
    a, _, _ = _port_session(cfg, init)
    b, _, _ = _port_session(cfg, init, backend=backend)
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k


def test_round_timeout_with_dead_silo():
    """Three of four silos start: the server aggregates those that
    reported once the round timeout fires."""
    args, fed, bundle = _port_parts(dict(SESSION, comm_round=2,
                                         round_timeout_s=1.0))
    from fedml_tpu_torch.core.distributed.communication.inproc import \
        InProcBroker
    args.inproc_broker = InProcBroker()
    server = TR.build_server(args, fed, bundle, backend="INPROC",
                             device="cpu")
    server.client_num = 3               # the online handshake: 3 silos
    server.aggregator.client_num = 4    # 4 expected models -> timeout path
    clients = [TR.build_client(args, fed, copy.deepcopy(bundle), rank=r,
                               backend="INPROC", device="cpu")
               for r in (1, 2, 3)]
    got = _run(server, clients)
    assert len(got["history"]) == 2
    for rt in got["round_times"]:     # the pieces lie inside the round
        assert len(rt) == 7
        pieces = (rt["broadcast_s"] + rt["wait_s"] + rt["aggregate_s"]
                  + rt["eval_s"])
        assert rt["end_s"] - rt["start_s"] >= pieces - 1e-9


def test_chaos_dropout_session_completes():
    """Seeded 25 % silo dropout and stragglers: the round timeout carries
    the session through every round, and the server's fault ledger
    reconciles injected dropouts with the silos that reported (the same
    schedule as the JAX package's plan)."""
    from fedml_tpu.core.chaos import FaultPlan as JPlan
    from fedml_tpu_torch.core.chaos import FaultPlan
    cfg = dict(SESSION, round_timeout_s=1.5, chaos_dropout_prob=0.25,
               chaos_straggler_prob=0.2, chaos_seed=23)
    plan = FaultPlan.from_args(Arguments(**cfg))
    ranks = [1, 2, 3, 4]
    assert any(plan.is_dropped(r, k) for r in range(3) for k in ranks)
    jplan = JPlan.from_args(JArgs(**cfg))
    assert [plan.is_dropped(r, k) for r in range(3) for k in ranks] == \
        [jplan.is_dropped(r, k) for r in range(3) for k in ranks]
    got, server, _ = _port_session(cfg, None)
    assert len(got["history"]) == 3
    recs = server.chaos_ledger.rounds()
    assert len(recs) == 3
    for rec in recs:
        want = [k for k in ranks if plan.is_dropped(rec["round_idx"], k)]
        assert sorted(rec["injected"]["dropped"]) == want
        observed = rec["observed"]
        assert 1 <= observed["reported"] <= observed["expected"]
        if want:
            # every injected dropout is a silo the server did not hear from
            assert observed["reported"] < observed["expected"]


def test_chaos_round_with_zero_uploads_is_skipped_not_stalled():
    """Seed 1 drops both silos in round 1: the broadcast-armed timeout
    (and its one grace interval) fires and the server skips the round,
    the global model unchanged, instead of stalling."""
    from fedml_tpu_torch.core.chaos import FaultPlan
    cfg = dict(SESSION, client_num_in_total=2, client_num_per_round=2,
               round_timeout_s=2.0, chaos_dropout_prob=0.5, chaos_seed=1)
    plan = FaultPlan.from_args(Arguments(**cfg))
    assert all(plan.is_dropped(1, rk) for rk in (1, 2))
    assert not any(plan.is_dropped(0, rk) for rk in (1, 2))
    got, server, _ = _port_session(cfg, None)
    skipped = [r for r in server.chaos_ledger.rounds()
               if r["observed"].get("skipped")]
    assert skipped and skipped[0]["round_idx"] == 1
    assert [h["round"] for h in got["history"]] == [0, 2]


def test_link_fault_session_completes():
    """Seeded link loss, duplication and delay at the Message send seam:
    the ONLINE re-announce, the round timeout, idempotent duplicate
    uploads and the stale-round tags carry the session through."""
    from fedml_tpu_torch.core.chaos import ChaosCommManager
    cfg = dict(SESSION, round_timeout_s=1.5, chaos_link_loss_prob=0.08,
               chaos_link_dup_prob=0.1, chaos_link_delay_prob=0.1,
               chaos_link_delay_s=0.2, chaos_seed=31)
    got, server, clients = _port_session(cfg, None)
    assert isinstance(server.com_manager, ChaosCommManager)
    assert len(got["history"]) == 3
    assert got["final_test_acc"] > 0.5
    events = [e for m in [server] + clients
              for e in m.com_manager.ledger.links()]
    assert events


def _client_stub(pkg, tmpdir, d=32):
    """A ClientMasterManager carrying only the wire-state attributes (the
    JAX package's ``__new__`` idiom for FSM-free tests)."""
    if pkg == "port":
        from fedml_tpu_torch.cross_silo.client.fedml_client_master_manager \
            import ClientMasterManager
        from fedml_tpu_torch.core.wire import wire_checkpointer
        mk = Arguments
    else:
        from fedml_tpu.cross_silo.client.fedml_client_master_manager \
            import ClientMasterManager
        from fedml_tpu.core.wire import wire_checkpointer
        mk = JArgs
    m = ClientMasterManager.__new__(ClientMasterManager)
    m.rank, m.round_idx = 1, 0
    m._cc_residual = m._global_vec = None
    m.trainer = types.SimpleNamespace(
        params_to_vec=lambda t: np.asarray(t, np.float32),
        params_template=np.zeros(d, np.float32))
    m._wire_ckpt = wire_checkpointer(
        mk(checkpoint_dir=tmpdir, checkpoint_every_rounds=1), "client_1")
    return m


def test_wire_checkpoint_resume_matches_uninterrupted(tmp_path):
    """A client whose wire state is restored from the checkpoint sends the
    uplinks of one that never crashed (the EF residual and the broadcast
    base both survive), and they are the JAX package's uplinks."""
    from fedml_tpu.core.wire import encode_update as jencode
    from fedml_tpu.utils.compression import CommCompressionSpec as JSpec
    from fedml_tpu_torch import prng
    from fedml_tpu_torch.core.wire import encode_update
    from fedml_tpu_torch.utils.compression import CommCompressionSpec
    d = 32
    rng = np.random.default_rng(5)
    globals_ = [rng.normal(size=d).astype(np.float32) for _ in range(4)]
    trained = [g + rng.normal(scale=0.1, size=d).astype(np.float32)
               for g in globals_]

    def run_rounds(mgr, start, stop, pkg="port"):
        blobs = []
        for r in range(start, stop):
            mgr.round_idx = r
            mgr._global_vec = globals_[r]
            if pkg == "port":
                enc = encode_update(
                    trained[r], base=mgr._global_vec,
                    spec=CommCompressionSpec("topk_qsgd", ratio=0.25),
                    residual=mgr._cc_residual,
                    rng=prng.fold_in(prng.PRNGKey(97), r))
            else:
                enc = jencode(
                    trained[r], base=mgr._global_vec,
                    spec=JSpec("topk_qsgd", ratio=0.25),
                    residual=mgr._cc_residual,
                    rng=jax.random.fold_in(jax.random.PRNGKey(97), r))
            mgr._cc_residual = enc.residual
            blobs.append(enc.payload)
            mgr._save_wire_state()
        return blobs

    whole = _client_stub("port", str(tmp_path / "a"), d)
    blobs_a = run_rounds(whole, 0, 4)
    whole._wire_ckpt.close()
    crashed = _client_stub("port", str(tmp_path / "b"), d)
    blobs_b = run_rounds(crashed, 0, 2)
    crashed._wire_ckpt.close()           # "crash" after round 1's save
    resumed = _client_stub("port", str(tmp_path / "b"), d)
    resumed._restore_wire_state()
    np.testing.assert_array_equal(resumed._cc_residual, crashed._cc_residual)
    blobs_b += run_rounds(resumed, 2, 4)
    resumed._wire_ckpt.close()
    jax_stub = _client_stub("jax", str(tmp_path / "j"), d)
    blobs_j = run_rounds(jax_stub, 0, 4, pkg="jax")
    jax_stub._wire_ckpt.close()
    for a, b, j in zip(blobs_a, blobs_b, blobs_j):
        assert set(a) == set(b) == set(j)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
            np.testing.assert_array_equal(a[key], np.asarray(j[key]))


def test_entry_points_run_a_tcp_session():
    """``run_cross_silo_server`` / ``run_cross_silo_client`` on the CPU:
    one server and two silos over TCP, the session the JAX package's
    entry points run."""
    cfg = dict(SESSION, client_num_in_total=2, client_num_per_round=2,
               comm_round=2, backend="TCP",
               tcp_base_port=free_port_base(3))
    cfg.pop("training_type")
    box = {}
    st = threading.Thread(target=lambda: box.setdefault(
        "r", fedml_tpu_torch.run_cross_silo_server(device="cpu", **cfg)),
        daemon=True)
    st.start()
    import time
    for _ in range(200):
        try:
            import socket
            socket.create_connection(("127.0.0.1", cfg["tcp_base_port"]),
                                     timeout=0.5).close()
            break
        except OSError:
            time.sleep(0.1)
    silos = [threading.Thread(target=fedml_tpu_torch.run_cross_silo_client,
                              kwargs=dict(device="cpu", rank=r, **cfg),
                              daemon=True) for r in (1, 2)]
    for t in silos:
        t.start()
    st.join(timeout=JOIN_S)
    assert not st.is_alive()
    r = box["r"]
    assert len(r["history"]) == 2 and r["final_test_acc"] > 0.5
    assert set(r["params"]) == {"Dense_0.weight", "Dense_0.bias"}
    for t in silos:
        t.join(timeout=10)
        assert not t.is_alive()


@pytest.mark.parametrize("knobs,name", [
    (dict(federated_optimizer="SA"), "secure aggregation"),
    (dict(federated_optimizer="LSA"), "LightSecAgg"),
    (dict(round_mode="async_buffered", federated_optimizer="SA"),
     "async_buffered"),
    (dict(federated_optimizer="split_nn"), "split learning"),
    (dict(federated_optimizer="decentralized_fl"), "gossip"),
    (dict(federated_optimizer="vertical_fl"), "vertical"),
    (dict(scenario="hierarchical"), "hierarchical")])
@pytest.mark.parametrize("role", ["server", "client"])
def test_unported_cross_silo_features_raise(knobs, name, role):
    """Every cross-silo protocol is ported now: each builds its own party
    for the role (``tests/test_torch_secagg.py``, ``test_torch_lsa.py``,
    ``test_torch_multiparty.py``, ``test_torch_gossip.py`` and
    ``test_torch_hierarchical.py`` run them). SA and LSA build their
    managers before the ``round_mode`` dispatch, as the JAX runner does:
    SA under ``round_mode: async_buffered`` builds the SA managers, and
    async without SA the buffered-async server and its silos
    (``tests/test_torch_async_cross_silo.py`` runs them)."""
    from fedml_tpu_torch.core.distributed.communication.inproc import \
        InProcBroker
    kw = dict(device="cpu", backend="INPROC", dataset="synthetic_mnist",
              model="lr", client_num_in_total=2, client_num_per_round=2,
              max_total_samples=16, enable_tracking=False, rank=1, **knobs)
    ported = {"secure aggregation": ("SecAggServerManager",
                                     "SecAggClientManager"),
              "LightSecAgg": ("LSAServerManager", "LSAClientManager"),
              "async_buffered": ("SecAggServerManager",
                                 "SecAggClientManager"),
              "split learning": ("SplitNNServerManager",
                                 "SplitNNClientManager"),
              "gossip": ("GossipNodeManager", "GossipNodeManager"),
              "vertical": ("VFLServerManager", "VFLPartyManager"),
              "hierarchical": ("FedMLServerManager",
                               "ClientMasterManager")}
    if knobs.get("federated_optimizer") in ("SA", "LSA"):
        pytest.importorskip("cryptography")
    runner = fedml_tpu_torch.cross_silo_runner(
        role, inproc_broker=InProcBroker(), **kw)
    manager = runner.runner.manager
    assert type(manager).__name__ == ported[name][role == "client"]
    if name == "hierarchical" and role == "client":
        assert type(manager.trainer).__name__ == "HierarchicalSiloTrainer"
    if role == "client" and name in ("secure aggregation", "LightSecAgg",
                                     "async_buffered"):
        # a secure silo trains plain FedAvg steps on its device
        assert manager.trainer.opt.name == "FedAvg"
        assert manager.trainer.device.type == "cpu"
    manager.com_manager.stop_receive_message()
    if "round_mode" in knobs:
        # without SA, async_buffered builds the buffered-async parties
        runner = fedml_tpu_torch.cross_silo_runner(
            role, device="cpu", backend="INPROC", dataset="synthetic_mnist",
            model="lr", client_num_in_total=2, client_num_per_round=2,
            max_total_samples=16, enable_tracking=False, rank=1,
            round_mode="async_buffered", inproc_broker=InProcBroker())
        from fedml_tpu_torch.cross_silo.server.async_server import \
            AsyncFedMLServerManager
        manager = runner.runner.manager
        assert (isinstance(manager, AsyncFedMLServerManager)
                if role == "server" else manager._async_mode)


def test_cross_silo_refuses_a_user_aggregator_and_no_cuda(monkeypatch):
    from fedml_tpu_torch.runner import FedMLRunner
    args, fed, bundle = _port_parts(dict(SESSION, role="server"))
    with pytest.raises(NotImplementedError, match="server_aggregator"):
        FedMLRunner(args, device="cpu", dataset=fed, model=bundle,
                    server_aggregator=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (fedml_tpu_torch.run_cross_silo_server,
               fedml_tpu_torch.run_cross_silo_client):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(backend="TCP")


def test_inproc_helper_runs_on_the_card_unless_cpu(jax_session,
                                                   monkeypatch):
    """``run_cross_silo_inproc`` resolves its device as ``run_simulation``
    does: ``device="cpu"`` runs the session (the same params as the
    builders' INPROC session, bitwise), no device without CUDA raises
    before any party is built."""
    _, init = jax_session
    cfg = dict(SESSION, comm_round=2)
    ref, _, _ = _port_session(cfg, init)
    args, fed, bundle = _port_parts(cfg)
    got = TR.run_cross_silo_inproc(args, fed, bundle, device="cpu",
                                   init_params=init)
    for k, v in ref["params"].items():
        assert torch.equal(v, got["params"][k]), k
    assert got["params"][k].device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(TR, "build_server",
                        lambda *a, **k: built.append(a))
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.run_cross_silo_inproc(args, fed, bundle)
    assert not built
