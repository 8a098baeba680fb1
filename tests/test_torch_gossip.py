"""The port's decentralized (gossip) FL against the JAX package's.

Bundled digits, LR, 4 nodes on a ring (``topology_neighbors`` 2), lr 0.1,
seed 5, the JAX init carried across (``interop.flax_to_state_dict``),
house tolerance:

* the SP ``DecentralizedSimulator`` (local SGD, then ``P <- W @ P``)
  equals the JAX one after 2 rounds, node by node;
* the INPROC gossip session equals the JAX session: the average model,
  its accuracy and the consensus distance;
* the nodes' neighbor sets and the row-stochastic ``W`` are the JAX
  package's;
* with ``gossip_compression: topk_qsgd`` every N2N blob the port's nodes
  send equals the JAX package's ``ef_compress_vec`` of the same inputs
  bit for bit, and the JAX session's blob of the same node and round:
  the same kept indices and quantized levels bit for bit, the scale
  within a few float32 ulps (the trained parameters it is the maximum of
  differ between the frameworks at float rounding, ~5e-8);
* a session under seeded link loss and duplication finishes (the resend
  loop), as the JAX package's ``tests/test_chaos.py`` asserts;
* the entry points: the runner dispatches ``decentralized_fl`` on the
  simulation platform and ``decentralized_fl`` / ``gossip`` under
  ``training_type: cross_silo``.
"""

from __future__ import annotations

import threading

import jax
import numpy as np
import pytest

from fedml_tpu import data as jdata
from fedml_tpu import model as jmodel
from fedml_tpu.arguments import Arguments as JArgs
from fedml_tpu_torch import data as tdata
from fedml_tpu_torch import model as tmodel
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.interop import flax_to_state_dict

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
GOSSIP = dict(dataset="digits", model="lr", client_num_in_total=4,
              client_num_per_round=4, comm_round=2, epochs=1, batch_size=32,
              learning_rate=0.1, frequency_of_the_test=1, random_seed=5,
              federated_optimizer="decentralized_fl", topology_neighbors=2,
              enable_tracking=False)
COMPRESSED = dict(gossip_compression="topk_qsgd", comm_compression_ratio=0.1,
                  comm_round=3)


def _jax_parts(cfg):
    args = JArgs(**cfg)
    fed, od = jdata.load(args)
    return args, fed, jmodel.create(args, od)


def _port_parts(cfg):
    args = Arguments(**cfg)
    fed, od = tdata.load(args)
    return args, fed, tmodel.create(args, od, fed.input_shape)


def _jax_init(cfg):
    _, fed, bundle = _jax_parts(cfg)
    key = jax.random.split(jax.random.PRNGKey(cfg["random_seed"]))[0]
    return flax_to_state_dict(jax.device_get(bundle.init(key,
                                                         fed.train.x[0, 0])))


def _close(port, ref, rtol=RTOL, atol=ATOL):
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(port[k].detach().cpu().numpy(), ref[k],
                                   rtol=rtol, atol=atol, err_msg=k)


def _jax_state(tree):
    return flax_to_state_dict(jax.device_get(tree))


def test_sp_simulator_matches_jax():
    from fedml_tpu.runner import FedMLRunner as JRunner
    from fedml_tpu_torch.runner import FedMLRunner
    from fedml_tpu_torch.simulation.sp.decentralized import \
        DecentralizedSimulator
    jargs, jfed, jbundle = _jax_parts(GOSSIP)
    ref = JRunner(jargs, dataset=jfed, model=jbundle).run()
    args, fed, bundle = _port_parts(GOSSIP)
    runner = FedMLRunner(args, device="cpu", dataset=fed, model=bundle,
                         init_params=_jax_init(GOSSIP))
    assert isinstance(runner.runner, DecentralizedSimulator)
    got = runner.run()
    _close(got["params"], _jax_state(ref["params"]))
    # every node, not only their average
    nodes = jax.device_get(ref["node_params"])
    for i in range(4):
        _close({k: v[i] for k, v in got["node_params"].items()},
               flax_to_state_dict(jax.tree_util.tree_map(lambda a: a[i],
                                                         nodes)))
    assert [h["test_acc"] for h in got["history"]] == \
        [h["test_acc"] for h in ref["history"]]
    np.testing.assert_allclose(
        [h["consensus_dist"] for h in got["history"]],
        [h["consensus_dist"] for h in ref["history"]], rtol=RTOL)


def test_inproc_session_matches_jax():
    from fedml_tpu.cross_silo.decentralized import run_gossip_inproc as jrun
    from fedml_tpu_torch.cross_silo.decentralized import run_gossip_inproc
    cfg = dict(GOSSIP, training_type="cross_silo")
    jargs, jfed, jbundle = _jax_parts(cfg)
    ref = jrun(jargs, jfed, jbundle)
    args, fed, bundle = _port_parts(cfg)
    got = run_gossip_inproc(args, fed, bundle, device="cpu",
                            init_params=_jax_init(cfg))
    _close(got["params"], _jax_state(ref["params"]))
    assert got["final_test_acc"] == ref["final_test_acc"]
    np.testing.assert_allclose(got["consensus_dist"], ref["consensus_dist"],
                               rtol=RTOL)
    assert got["rounds"] == ref["rounds"] == 2
    assert [h["round"] for h in got["history"]] == [0, 1]


def test_neighbor_sets_and_mixing_matrix():
    from fedml_tpu.core.distributed.communication.inproc import \
        InProcBroker as JBroker
    from fedml_tpu.cross_silo.decentralized import GossipNodeManager as JNode
    from fedml_tpu_torch.core.distributed.communication.inproc import \
        InProcBroker
    from fedml_tpu_torch.cross_silo.decentralized import GossipNodeManager
    cfg = dict(GOSSIP, training_type="cross_silo")
    jargs, jfed, jbundle = _jax_parts(cfg)
    jargs.inproc_broker = JBroker()
    args, fed, bundle = _port_parts(cfg)
    args.inproc_broker = InProcBroker()
    nodes = [GossipNodeManager(args, fed, bundle, rank=r, size=4,
                               backend="INPROC", device="cpu")
             for r in range(4)]
    jnodes = [JNode(jargs, jfed, jbundle, rank=r, size=4, backend="INPROC")
              for r in range(4)]
    for nd, jn in zip(nodes, jnodes):
        assert nd.neighbors == jn.neighbors
        np.testing.assert_array_equal(nd.W, jn.W)
        for j in nd.neighbors:   # symmetric: i receives from j, j from i
            assert nd.rank in nodes[j].neighbors
        np.testing.assert_allclose(nd.W.sum(axis=1), 1.0, atol=1e-9)
    for m in nodes + jnodes:
        m.com_manager.stop_receive_message()


def _blob_spy(monkeypatch, module):
    """Record every ``encode_update`` of ``module``'s gossip nodes under
    its key (one key per node and round)."""
    calls, lock = {}, threading.Lock()
    orig = module.encode_update

    def spy(vec, **kw):
        enc = orig(vec, **kw)
        with lock:
            calls[np.asarray(kw["rng"]).tobytes()] = (
                np.array(vec, np.float32, copy=True),
                np.array(kw["base"], np.float32, copy=True),
                None if kw["residual"] is None else
                np.array(kw["residual"], np.float32, copy=True),
                kw["spec"], np.asarray(kw["rng"]), enc.payload)
        return enc

    monkeypatch.setattr(module, "encode_update", spy)
    return calls


def _same_blob(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), k


def _same_selection(a, b):
    """Blobs equal bit for bit but for the float scale ``s``."""
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "s":
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6)
        else:
            assert np.asarray(a[k]).tobytes() == \
                np.asarray(b[k]).tobytes(), k


def test_compressed_blobs_match_jax(monkeypatch):
    """Three rounds, a dense seed round then two compressed ones: each
    node's blob equals JAX's ``ef_compress_vec`` of the port's own inputs
    (delta against the sent reconstruction, residual, key) bit for bit,
    and the JAX session's blob for the same node and round in its kept
    indices and levels (its scale to a few ulps)."""
    from fedml_tpu.cross_silo import decentralized as J
    from fedml_tpu.utils import compression as JC
    from fedml_tpu_torch.cross_silo import decentralized as T
    cfg = dict(GOSSIP, training_type="cross_silo", **COMPRESSED)
    jcalls = _blob_spy(monkeypatch, J)
    tcalls = _blob_spy(monkeypatch, T)
    jargs, jfed, jbundle = _jax_parts(cfg)
    ref = J.run_gossip_inproc(jargs, jfed, jbundle)
    args, fed, bundle = _port_parts(cfg)
    got = T.run_gossip_inproc(args, fed, bundle, device="cpu",
                              init_params=_jax_init(cfg))
    assert len(tcalls) == len(jcalls) == 4 * 2   # rounds 1 and 2
    assert sorted(tcalls) == sorted(jcalls)
    for key, (vec, base, res, spec, rng, blob) in tcalls.items():
        _same_selection(blob, jcalls[key][5])
        jspec = JC.CommCompressionSpec(method=spec.method, ratio=spec.ratio,
                                       levels=spec.levels)
        jb, _ = JC.ef_compress_vec(vec - base, res, jspec,
                                   jax.numpy.asarray(rng, jax.numpy.uint32))
        _same_blob(blob, jb)
    _close(got["params"], _jax_state(ref["params"]))
    assert got["final_test_acc"] == ref["final_test_acc"]


def test_session_survives_link_loss():
    from fedml_tpu_torch.cross_silo.decentralized import run_gossip_inproc
    cfg = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=4,
               client_num_per_round=4, comm_round=3, epochs=1,
               batch_size=16, learning_rate=0.1, frequency_of_the_test=2,
               random_seed=42, topology_neighbors=2,
               federated_optimizer="decentralized_fl",
               training_type="cross_silo", chaos_link_loss_prob=0.15,
               chaos_link_dup_prob=0.1, chaos_seed=13,
               enable_tracking=False)
    args, fed, bundle = _port_parts(cfg)
    result = run_gossip_inproc(args, fed, bundle, device="cpu")
    assert result is not None, "gossip session stalled under link loss"
    assert result["rounds"] == 3
    assert result["final_test_acc"] > 0.5


@pytest.mark.parametrize("fo", ["decentralized_fl", "gossip"])
def test_cross_silo_runner_builds_gossip_nodes(fo):
    """``federated_optimizer`` decentralized_fl / gossip under
    ``training_type: cross_silo``: the server role is node 0, a client
    node ``max(rank, 1)``; both on the CPU when asked."""
    import fedml_tpu_torch
    from fedml_tpu_torch.core.distributed.communication.inproc import \
        InProcBroker
    from fedml_tpu_torch.cross_silo.decentralized import GossipNodeManager
    broker = InProcBroker()
    for role, rank in (("server", 0), ("client", 2)):
        runner = fedml_tpu_torch.cross_silo_runner(
            role, device="cpu", backend="INPROC", dataset="synthetic_mnist",
            model="lr", client_num_in_total=4, client_num_per_round=4,
            max_total_samples=64, enable_tracking=False, rank=rank,
            federated_optimizer=fo, inproc_broker=broker)
        node = runner.runner.manager
        assert isinstance(node, GossipNodeManager)
        assert node.rank == rank and node.device.type == "cpu"
        node.com_manager.stop_receive_message()


def test_seeded_init_session_matches_sp_simulator():
    """Without ``init_params`` a node starts from its trainer's seeded
    init, the SP simulator's too: the session's average model equals the
    SP loop's up to the mix's reassociation (the JAX golden's check,
    ``tests/test_decentralized_session.py``)."""
    from fedml_tpu_torch.cross_silo.decentralized import run_gossip_inproc
    from fedml_tpu_torch.runner import FedMLRunner
    args, fed, bundle = _port_parts(dict(GOSSIP, training_type="cross_silo"))
    got = run_gossip_inproc(args, fed, bundle, device="cpu")
    args, fed, bundle = _port_parts(GOSSIP)
    ref = FedMLRunner(args, device="cpu", dataset=fed, model=bundle).run()
    _close(got["params"], {k: v.numpy() for k, v in ref["params"].items()})
    assert got["final_test_acc"] == ref["final_test_acc"]
    np.testing.assert_allclose(got["consensus_dist"],
                               ref["history"][-1]["consensus_dist"],
                               rtol=RTOL)


def test_node_zero_counts_its_evaluation_launches(monkeypatch):
    """Node 0 reads the kernel counters just before its evaluation of the
    average model and just after it (the card script splits its launches
    into training and evaluation with them); the other nodes record
    none. A spy evaluation adds 3 launches to B1's counter."""
    import copy

    from fedml_tpu_torch.core.kernels import conv_block
    from fedml_tpu_torch.cross_silo import run_inproc_session
    from fedml_tpu_torch.cross_silo.decentralized import GossipNodeManager
    real = GossipNodeManager.eval_fn

    def spy(self):
        ev = real(self)

        def counted(params):
            conv_block.fused_block.launches += 3
            return ev(params)
        return counted

    monkeypatch.setattr(GossipNodeManager, "eval_fn", spy)
    monkeypatch.setattr(conv_block.fused_block, "launches", 5)
    args, fed, bundle = _port_parts(dict(GOSSIP, training_type="cross_silo"))
    nodes = []

    def build():
        nodes.extend(GossipNodeManager(args, fed, copy.deepcopy(bundle),
                                       rank=r, size=4, backend="INPROC",
                                       device="cpu") for r in range(4))
        return nodes

    assert run_inproc_session(args, build)["rounds"] == 2
    assert nodes[0].launches_before_eval["fused_block"] == 5
    assert nodes[0].eval_launches == {"fused_block": 3, "flash_fwd": 0,
                                      "flash_dq": 0, "flash_dkv": 0}
    assert all(n.eval_launches is None and n.launches_before_eval is None
               for n in nodes[1:])
