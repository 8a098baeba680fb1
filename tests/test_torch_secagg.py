"""The port's SecAgg cross-silo session (``fedml_tpu_torch/cross_silo/
secagg``) against the JAX package's, on the JAX golden's session shape
(synthetic MNIST, LR, 4 silos, 2 rounds, lr 0.1, seed 13), the JAX init
carried across:

* the INPROC session equals ``fedml_tpu.cross_silo.secagg.run_secagg_inproc``
  within the house tolerance plus one quantum per silo and round (the
  silos' float32 deltas differ in the last bits, and a delta within that
  gap of a rounding boundary quantizes to the neighbouring level), and the
  port's plain horizontal session at the JAX golden's ``1e-3``;
* a silo dropping before its masked input, one dropping after the shares
  (its mask key reconstructed), a straggler that rejoins the next round:
  each ends at plain FedAvg over the silos that took part;
* the active-server overlap refusal and the once-per-round answer, the
  relayed bytes being ciphertext only, the threshold <= n/2 and
  sparsifier refusals;
* ``secagg_compress_bits: 4`` for one round against JAX's;
* a JAX SA server with port silos over TCP on loopback ends at the all-JAX
  session's model.
"""

from __future__ import annotations

import copy
import threading

import jax
import numpy as np
import pytest
import torch

pytest.importorskip(
    "cryptography",
    reason="core/mpc/channels.py needs the cryptography package")

from fedml_tpu import data as jdata  # noqa: E402
from fedml_tpu import model as jmodel  # noqa: E402
from fedml_tpu.arguments import Arguments as JArgs  # noqa: E402
from fedml_tpu.cross_silo import secagg as jsa  # noqa: E402
from fedml_tpu.cross_silo.horizontal import runner as JR  # noqa: E402
import fedml_tpu_torch  # noqa: E402
from fedml_tpu_torch import data as tdata  # noqa: E402
from fedml_tpu_torch import model as tmodel  # noqa: E402
from fedml_tpu_torch.arguments import Arguments  # noqa: E402
from fedml_tpu_torch.core.algframe.client_trainer import \
    make_trainer_spec  # noqa: E402
from fedml_tpu_torch.core.distributed.communication.inproc import \
    InProcBroker  # noqa: E402
from fedml_tpu_torch.core.distributed.communication.message import \
    Message  # noqa: E402
from fedml_tpu_torch.core.mpc import channels  # noqa: E402
from fedml_tpu_torch.cross_silo import secagg as tsa  # noqa: E402
from fedml_tpu_torch.cross_silo.client.trainer import SiloTrainer  # noqa: E402
from fedml_tpu_torch.cross_silo.horizontal import runner as TR  # noqa: E402
from fedml_tpu_torch.interop import flax_to_state_dict  # noqa: E402
from fedml_tpu_torch.optimizers.registry import create_optimizer  # noqa: E402
from fedml_tpu_torch.simulation.gpu.engine import load_params  # noqa: E402

from test_torch_comm import free_port_base  # noqa: E402
from torch_port_support import single_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
SESSION = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=4,
               client_num_per_round=4, comm_round=2, epochs=1, batch_size=32,
               learning_rate=0.1, frequency_of_the_test=1, random_seed=13,
               training_type="cross_silo", enable_tracking=False)
TIMEOUT_S = 1.5


def _jax_parts(cfg):
    args = JArgs(**cfg)
    fed, od = jdata.load(args)
    return args, fed, jmodel.create(args, od)


def _port_parts(cfg):
    args = Arguments(**cfg)
    fed, od = tdata.load(args)
    return args, fed, tmodel.create(args, od, fed.input_shape)


def _init(cfg):
    _, fed, bundle = _jax_parts(cfg)
    key = jax.random.split(jax.random.PRNGKey(cfg["random_seed"]))[0]
    return flax_to_state_dict(jax.device_get(bundle.init(key,
                                                         fed.train.x[0, 0])))


def _quantum(cfg, rounds):
    """One quantum per silo and round of the aggregate: 2^-16 / sum(n)."""
    _, fed, _ = _port_parts(cfg)
    n = np.asarray(fed.train.num_samples)[:cfg["client_num_per_round"]]
    return rounds * len(n) * 2.0 ** -16 / float(n.sum())


def _close(port, ref, rtol=RTOL, atol=ATOL):
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(port[k].detach().cpu().numpy(), ref[k],
                                   rtol=rtol, atol=atol, err_msg=k)


def _port_sa(cfg, init, client_factory=None):
    args, fed, bundle = _port_parts(cfg)
    return tsa.run_secagg_inproc(args, fed, bundle, device="cpu",
                                 init_params=init,
                                 client_factory=client_factory)


@pytest.fixture(scope="module")
def jax_session():
    """The all-JAX SA session and its init, once per module."""
    args, fed, bundle = _jax_parts(SESSION)
    ref = jsa.run_secagg_inproc(args, fed, bundle)
    assert ref is not None and "error" not in ref
    return flax_to_state_dict(jax.device_get(ref["params"])), ref, \
        _init(SESSION)


def test_sa_session_matches_jax(jax_session):
    ref, jres, init = jax_session
    got = _port_sa(SESSION, init)
    assert got is not None and "error" not in got, got
    _close(got["params"], ref, atol=ATOL + _quantum(SESSION, 2))
    assert [h["round"] for h in got["history"]] == [0, 1]
    np.testing.assert_allclose([h["test_acc"] for h in got["history"]],
                               [h["test_acc"] for h in jres["history"]],
                               atol=2e-3)
    assert got["final_test_acc"] > 0.6
    assert all(v.device.type == "cpu" for v in got["params"].values())


def test_sa_session_matches_plain_horizontal(jax_session):
    _, _, init = jax_session
    got = _port_sa(SESSION, init)
    args, fed, bundle = _port_parts(SESSION)
    plain = TR.run_cross_silo_inproc(args, fed, bundle, device="cpu",
                                     init_params=init)
    _close(got["params"], {k: v.numpy() for k, v in plain["params"].items()},
           rtol=1e-3, atol=1e-3)


def _survivors_fedavg(cfg, init, survivors, rounds):
    """Plain weighted FedAvg over ``survivors`` with the port's silo
    trainer: what a session that dropped the others must end at."""
    args, fed, bundle = _port_parts(cfg)
    spec = make_trainer_spec(fed, bundle)
    params = load_params(bundle, init, "cpu")
    trainers = {i: SiloTrainer(args, fed, copy.deepcopy(bundle), spec,
                               create_optimizer(args, spec), "cpu")
                for i in survivors}
    for r in range(rounds):
        deltas, ws = [], []
        for i in survivors:
            new_p, n, _ = trainers[i].train(params, i, r)
            deltas.append({k: new_p[k] - params[k] for k in params})
            ws.append(n)
        params = {k: params[k] + sum(w * d[k] for w, d in zip(ws, deltas))
                  / sum(ws) for k in params}
    return {k: v.numpy() for k, v in params.items()}


def _factory(cls, rank_of_cls):
    def make(rank, args, trainer):
        c = cls if rank == rank_of_cls else tsa.SecAggClientManager
        return c(args, trainer, rank=rank,
                 size=args.client_num_per_round + 1, backend="INPROC")
    return make


def test_sa_dropout_before_masked_input(jax_session):
    """Silo 4 sets up its channel key and never trains: each round's
    cohort is the other three, and the model is their FedAvg."""
    _, _, init = jax_session

    class Dead(tsa.SecAggClientManager):
        def on_train(self, msg):
            return

    cfg = dict(SESSION, round_timeout_s=TIMEOUT_S)
    got = _port_sa(cfg, init, _factory(Dead, 4))
    assert got is not None and "error" not in got, got
    assert len(got["history"]) == 2
    _close(got["params"], _survivors_fedavg(SESSION, init, [0, 1, 2], 2),
           rtol=1e-3, atol=1e-3)


def test_sa_dropout_after_shares_reconstructs_masks(jax_session):
    """Silo 2 shares its secrets, then never masks: the survivors' masked
    vectors carry pairwise masks with it, which the server cancels from
    its mask key, rebuilt from the Shamir shares."""
    _, _, init = jax_session

    class DropAfterShares(tsa.SecAggClientManager):
        def on_routed_shares(self, msg):
            return

    cfg = dict(SESSION, comm_round=1, round_timeout_s=TIMEOUT_S)
    got = _port_sa(cfg, init, _factory(DropAfterShares, 2))
    assert got is not None and "error" not in got, got
    _close(got["params"], _survivors_fedavg(SESSION, init, [0, 2, 3], 1),
           rtol=1e-3, atol=1e-3)


def test_sa_straggler_rejoins_next_round(jax_session):
    _, _, init = jax_session
    rejoined = []

    class SlowFirstRound(tsa.SecAggClientManager):
        def on_train(self, msg):
            if int(msg.get("round", 0)) == 0:
                return  # missed the round-0 deadline
            rejoined.append(int(msg.get("round")))
            super().on_train(msg)

    cfg = dict(SESSION, round_timeout_s=TIMEOUT_S)
    got = _port_sa(cfg, init, _factory(SlowFirstRound, 3))
    assert got is not None and "error" not in got, got
    assert len(got["history"]) == 2 and rejoined == [1]
    assert got["final_test_acc"] > 0.4


def test_client_refuses_active_server_unmask_attack():
    args = Arguments(**SESSION)
    args.inproc_broker = InProcBroker()
    c = tsa.SecAggClientManager(args, trainer=None, rank=1, size=5,
                                backend="INPROC")
    sent = []
    c.send_message = sent.append
    c.finish = lambda: None

    def held():
        return {"round": 0,
                "held": {i: ([[1, 2]] * 6, [[1, 2]] * 11) for i in range(4)}}

    def request(surviving, dropped):
        msg = Message(tsa.SAMessage.S2C_UNMASK_REQUEST, 0, 1)
        msg.add_params(tsa.SAMessage.KEY_ROUND, 0)
        msg.add_params(tsa.SAMessage.KEY_SURVIVING, surviving)
        msg.add_params(tsa.SAMessage.KEY_DROPPED, dropped)
        c.on_unmask_request(msg)

    c._round = held()
    request([0, 1, 2], [2, 3])   # client 2 in both lists: refused
    assert sent == []
    c._round = held()
    request([0, 1, 2], [3])      # answered once, secrets wiped
    assert len(sent) == 1 and c._round is None
    c._round = held()
    request([0, 1], [2])         # the same round again: nothing
    assert len(sent) == 1


def test_server_relays_only_ciphertext(jax_session, monkeypatch):
    import msgpack
    _, _, init = jax_session
    seen = {}

    class SpyServer(tsa.SecAggServerManager):
        def on_shares(self, msg):
            seen[msg.get_sender_id() - 1] = dict(
                msg.get(tsa.SAMessage.KEY_SHARES))
            super().on_shares(msg)

    monkeypatch.setattr(tsa, "SecAggServerManager", SpyServer)
    got = _port_sa(dict(SESSION, comm_round=1), init)
    assert got is not None and "error" not in got
    assert len(seen) == 4
    eve_sk, eve_pk = channels.keygen()
    for owner, routed in seen.items():
        for j, blob in routed.items():
            blob = bytes(blob)
            with pytest.raises(Exception):
                assert isinstance(msgpack.unpackb(blob), list)
            with pytest.raises(channels.DecryptError):
                channels.open_sealed(eve_sk, eve_pk, blob,
                                     aad=channels.pair_aad(
                                         int(owner), int(j), b"sa-round-0"))


@pytest.mark.parametrize("knobs,match", [
    (dict(secagg_threshold=2), "majority threshold"),
    (dict(comm_compression="topk"), "cannot compose with SecAgg")])
@pytest.mark.parametrize("role", ["server", "client"])
def test_sa_refusals(knobs, match, role):
    with pytest.raises(ValueError, match=match):
        fedml_tpu_torch.cross_silo_runner(
            role, device="cpu", backend="INPROC", inproc_broker=InProcBroker(),
            federated_optimizer="SA", rank=1,
            **dict(SESSION, max_total_samples=64, **knobs))


def test_lane_compressed_round_matches_jax():
    """4-bit lanes (5 per word at 4 silos), one round: the masked sum
    decodes to the JAX session's model within the tolerance plus one lane
    quantum (the round's scale over sum(n)) per silo."""
    cfg = dict(SESSION, comm_round=1, secagg_compress_bits=4)
    jargs, jfed, jbundle = _jax_parts(cfg)
    ref = jsa.run_secagg_inproc(jargs, jfed, jbundle)
    got = _port_sa(cfg, _init(cfg))
    assert got is not None and "error" not in got, got
    from fedml_tpu_torch.core.wire import plan_for, suggest_scale
    scale = suggest_scale(4.0, plan_for(4, 4))
    lane_q = _quantum(cfg, 1) * 2.0 ** 16 * scale
    _close(got["params"], flax_to_state_dict(jax.device_get(ref["params"])),
           atol=ATOL + lane_q)
    assert got["history"][0]["test_acc"] == pytest.approx(
        ref["history"][0]["test_acc"], abs=2e-3)


def test_mixed_session_jax_server_port_silos_over_tcp(jax_session):
    ref, _, _ = jax_session
    base = free_port_base(5)
    cfg = dict(SESSION, backend="TCP", tcp_base_port=base,
               federated_optimizer="SA")
    jargs, jfed, jbundle = _jax_parts(dict(cfg, role="server"))
    server = JR.CrossSiloRunner(jargs, jfed, jbundle).manager
    targs, tfed, tbundle = _port_parts(cfg)
    silos = [TR.build_secure_client(targs, tfed, copy.deepcopy(tbundle), "sa",
                                    r, backend="TCP", device="cpu")
             for r in range(1, 5)]
    threads = [threading.Thread(target=s.run, daemon=True) for s in silos]
    for t in threads:
        t.start()
    st = threading.Thread(target=server.run, daemon=True)
    st.start()
    st.join(timeout=120)
    assert not st.is_alive(), "the session stalled"
    for s, t in zip(silos, threads):
        t.join(timeout=10)
        if t.is_alive():
            s.finish()
    got = server.result
    assert got is not None and "error" not in got, got
    params = flax_to_state_dict(jax.device_get(got["params"]))
    _close({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()},
           ref, atol=ATOL + _quantum(SESSION, 2))
