"""The port's LightSecAgg cross-silo session (``fedml_tpu_torch/cross_silo/
lightsecagg``) against the JAX package's, on the JAX golden's session
shape (synthetic MNIST, LR, 4 silos, lr 0.1, seed 11), the JAX init carried
across:

* the INPROC session equals ``fedml_tpu.cross_silo.lightsecagg.
  run_lsa_inproc`` within the house tolerance plus one quantum per silo
  and round, and the port's plain FedAvg session at the JAX golden's
  ``atol=5e-3``;
* one silo dropping before its upload: the one-shot decode recovers the
  three survivors' aggregate;
* a silo whose routed sub-mask fails authentication does not respond;
* lanes (``secagg_compress_bits``) and sparsifiers are refused.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

pytest.importorskip(
    "cryptography",
    reason="core/mpc/channels.py needs the cryptography package")

from fedml_tpu import data as jdata  # noqa: E402
from fedml_tpu import model as jmodel  # noqa: E402
from fedml_tpu.arguments import Arguments as JArgs  # noqa: E402
from fedml_tpu.cross_silo import lightsecagg as jlsa  # noqa: E402
import fedml_tpu_torch  # noqa: E402
from fedml_tpu_torch import data as tdata  # noqa: E402
from fedml_tpu_torch import model as tmodel  # noqa: E402
from fedml_tpu_torch.arguments import Arguments  # noqa: E402
from fedml_tpu_torch.core.distributed.communication.inproc import \
    InProcBroker  # noqa: E402
from fedml_tpu_torch.core.distributed.communication.message import \
    Message  # noqa: E402
from fedml_tpu_torch.core.mpc import channels  # noqa: E402
from fedml_tpu_torch.cross_silo import lightsecagg as tlsa  # noqa: E402
from fedml_tpu_torch.cross_silo.horizontal import runner as TR  # noqa: E402
from fedml_tpu_torch.interop import flax_to_state_dict  # noqa: E402

from torch_port_support import single_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
SESSION = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=4,
               client_num_per_round=4, comm_round=3, epochs=1, batch_size=32,
               learning_rate=0.1, frequency_of_the_test=1, random_seed=11,
               training_type="cross_silo", federated_optimizer="LSA",
               enable_tracking=False)


def _port_parts(cfg):
    args = Arguments(**cfg)
    fed, od = tdata.load(args)
    return args, fed, tmodel.create(args, od, fed.input_shape)


def _close(port, ref, rtol=RTOL, atol=ATOL):
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(port[k].detach().cpu().numpy(), ref[k],
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def jax_session():
    args = JArgs(**SESSION)
    fed, od = jdata.load(args)
    bundle = jmodel.create(args, od)
    ref = jlsa.run_lsa_inproc(args, fed, bundle)
    assert ref is not None and "error" not in ref
    key = jax.random.split(jax.random.PRNGKey(SESSION["random_seed"]))[0]
    init = flax_to_state_dict(jax.device_get(bundle.init(key,
                                                         fed.train.x[0, 0])))
    return flax_to_state_dict(jax.device_get(ref["params"])), ref, init


def _port_lsa(cfg, init, client_factory=None):
    args, fed, bundle = _port_parts(cfg)
    return tlsa.run_lsa_inproc(args, fed, bundle, device="cpu",
                               init_params=init,
                               client_factory=client_factory)


def test_lsa_matches_jax_and_plain_fedavg(jax_session):
    ref, jres, init = jax_session
    got = _port_lsa(SESSION, init)
    assert got is not None and "error" not in got, got
    assert len(got["history"]) == 3
    assert [h["survivors"] for h in got["history"]] == [4, 4, 4]
    args, fed, _ = _port_parts(SESSION)
    n = np.asarray(fed.train.num_samples)[:4]
    quanta = 3 * 4 * 2.0 ** -16 / float(n.sum())
    _close(got["params"], ref, atol=ATOL + quanta)
    np.testing.assert_allclose([h["test_acc"] for h in got["history"]],
                               [h["test_acc"] for h in jres["history"]],
                               atol=2e-3)
    assert got["final_test_acc"] > 0.6
    pargs, pfed, pbundle = _port_parts(dict(SESSION,
                                            federated_optimizer="FedAvg"))
    plain = TR.run_cross_silo_inproc(pargs, pfed, pbundle, device="cpu",
                                     init_params=init)
    _close(got["params"], {k: v.numpy() for k, v in plain["params"].items()},
           rtol=0, atol=5e-3)


def test_lsa_survives_dropout(jax_session):
    _, _, init = jax_session

    class Dropping(tlsa.LSAClientManager):
        def on_train(self, msg):
            self.finish()   # dies before training and uploading

    def factory(rank, args, trainer):
        cls = Dropping if rank == 4 else tlsa.LSAClientManager
        return cls(args, trainer, rank=rank, size=5, backend="INPROC")

    got = _port_lsa(dict(SESSION, comm_round=2, round_timeout_s=1.5), init,
                    factory)
    assert got is not None and "error" not in got, got
    assert [h["survivors"] for h in got["history"]] == [3, 3]
    assert got["final_test_acc"] > 0.5


def test_lsa_client_with_a_failed_blob_does_not_respond():
    """Any routed sub-mask that fails authentication poisons the sum: the
    silo answers nothing (the server's agg timeout takes it from there)."""
    args = Arguments(**SESSION)
    args.inproc_broker = InProcBroker()
    c = tlsa.LSAClientManager(args, trainer=None, rank=1, size=5,
                              backend="INPROC")
    sent = []
    c.send_message = sent.append
    peers = {i: channels.keygen() for i in (1, 2)}
    c.peer_publics = {i: pk for i, (_, pk) in peers.items()}
    sub = np.arange(6, dtype="<u4")

    def blob(i, tag=b"lsa-r0"):
        return channels.seal(peers[i][0], c.enc_pk, sub.tobytes(),
                             aad=channels.pair_aad(i, 0, tag))

    def request(routed):
        msg = Message(tlsa.LSAMessage.S2C_AGG_REQUEST, 0, 1)
        msg.add_params(tlsa.LSAMessage.KEY_ROUND, 0)
        msg.add_params(tlsa.LSAMessage.KEY_ROUTED, routed)
        c.on_agg_request(msg)

    request({"1": blob(1), "2": blob(2, tag=b"lsa-r1")})   # replayed blob
    assert sent == []
    request({"1": blob(1), "2": blob(2)})
    assert len(sent) == 1
    np.testing.assert_array_equal(sent[0].get(tlsa.LSAMessage.KEY_AGG),
                                  2 * sub)


@pytest.mark.parametrize("knob,value", [("secagg_compress_bits", 4),
                                        ("comm_compression", "topk")])
@pytest.mark.parametrize("role", ["server", "client"])
def test_lsa_refuses_lanes_and_compression(knob, value, role):
    with pytest.raises(ValueError, match=f"{knob}=.*incompatible with "
                                         f"LightSecAgg"):
        fedml_tpu_torch.cross_silo_runner(
            role, device="cpu", backend="INPROC", inproc_broker=InProcBroker(),
            rank=1, **dict(SESSION, max_total_samples=64, **{knob: value}))
