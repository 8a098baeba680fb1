"""The port's split learning and vertical FL against the JAX package's.

Bundled digits, 3 clients (split) or the pooled data cut into 3 feature
parties (vertical), 2 rounds, lr 0.1, seed 7, the JAX parts' initial
parameters carried across (``interop.split_params_from_flax`` /
``vfl_params_from_flax``), house tolerance:

* each SP simulator equals the JAX one: every part's parameters, and the
  per-round accuracies exactly;
* each distributed session (INPROC) equals the JAX session (the split
  head, the accuracies) and the port's SP simulator (the vertical
  parties' parameters);
* the runner dispatches ``split_nn``, the vertical names,
  ``decentralized_fl`` and ``hierarchicalfl`` on the simulation platform
  on either backend, and ``split_nn`` / ``splitnn`` and
  ``classical_vertical`` / ``vertical_fl`` / ``vfl`` under
  ``training_type: cross_silo`` (both roles, over TCP), as the JAX
  package's ``tests/test_multiparty_sessions.py`` checks its own;
* secure aggregation (SA, LSA) still raises, naming itself.
"""

from __future__ import annotations

import numpy as np
import pytest

from fedml_tpu import data as jdata
from fedml_tpu.arguments import Arguments as JArgs
from fedml_tpu_torch import data as tdata
from fedml_tpu_torch import model as tmodel
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.interop import (split_params_from_flax,
                                     variables_to_state_dict,
                                     vfl_params_from_flax)

from test_torch_comm import free_port_base
from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
BASE = dict(dataset="digits", model="lr", client_num_in_total=3,
            client_num_per_round=3, comm_round=2, epochs=1, batch_size=32,
            learning_rate=0.1, frequency_of_the_test=1, random_seed=7,
            enable_tracking=False)
SPLIT = dict(BASE, federated_optimizer="split_nn")
VFL = dict(BASE, federated_optimizer="vfl", party_num=3)


def _close(port, ref):
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(port[k].detach().cpu().numpy(), ref[k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def _accs(result):
    return [h["test_acc"] for h in result["history"]]


def _port_run(cfg, init):
    from fedml_tpu_torch.runner import FedMLRunner
    args = Arguments(**cfg)
    fed, od = tdata.load(args)
    runner = FedMLRunner(args, device="cpu", dataset=fed,
                         model=tmodel.create(args, od, fed.input_shape),
                         init_params=init)
    return runner, runner.run()


@pytest.fixture(scope="module")
def split_ref():
    """The JAX SP simulator's run, its init and the JAX session's run."""
    from fedml_tpu.cross_silo.split_learning import run_splitnn_inproc
    from fedml_tpu.simulation.sp.split_nn import SplitNNSimulator
    args = JArgs(**SPLIT)
    fed, _ = jdata.load(args)
    sim = SplitNNSimulator(args, fed, None)
    init = split_params_from_flax(sim.client_bottoms[0], sim.top_params)
    sp = sim.run()
    session = run_splitnn_inproc(JArgs(**dict(SPLIT,
                                              training_type="cross_silo")),
                                 fed)
    return init, sp, session


@pytest.fixture(scope="module")
def vfl_ref():
    from fedml_tpu.cross_silo.vertical import run_vfl_inproc
    from fedml_tpu.simulation.sp.vertical_fl import VerticalFLSimulator
    args = JArgs(**VFL)
    fed, _ = jdata.load(args)
    sim = VerticalFLSimulator(args, fed)
    init = vfl_params_from_flax(sim.party_params)
    sp = sim.run()
    session = run_vfl_inproc(JArgs(**dict(VFL, training_type="cross_silo")),
                             fed)
    return init, sp, session


def test_split_sp_simulator_matches_jax(split_ref):
    from fedml_tpu_torch.simulation.sp.split_nn import SplitNNSimulator
    init, ref, _ = split_ref
    runner, got = _port_run(SPLIT, init)
    assert isinstance(runner.runner, SplitNNSimulator)
    for part in ("bottom", "top"):
        _close(got["params"][part],
               variables_to_state_dict(ref["params"][part]))
    assert _accs(got) == _accs(ref)


def test_split_session_matches_jax(split_ref):
    from fedml_tpu_torch.cross_silo.split_learning import run_splitnn_inproc
    init, ref_sp, ref = split_ref
    args = Arguments(**dict(SPLIT, training_type="cross_silo"))
    fed, _ = tdata.load(args)
    got = run_splitnn_inproc(args, fed, device="cpu", init_params=init)
    _close(got["params"]["top"],
           variables_to_state_dict(ref["params"]["top"]))
    assert _accs(got) == _accs(ref) == _accs(ref_sp)
    assert got["rounds"] == 2


def test_split_padded_batch_leaves_params_unchanged():
    """A batch whose mask sums to 0 is no step (``split_nn.py:77-81``)."""
    import torch
    from fedml_tpu_torch.simulation.sp.split_nn import SplitNNSimulator
    args = Arguments(**SPLIT)
    fed, _ = tdata.load(args)
    sim = SplitNNSimulator(args, fed, device="cpu")
    sim.batch_real[0][:] = False   # every batch of client 0 is padding
    before = {k: v.clone() for k, v in sim.client_bottoms[0].items()}
    top = {k: v.clone() for k, v in sim.top_params.items()}
    sim._step(sim.client_bottoms[0], sim.top_params, 0)
    for k, v in before.items():
        assert torch.equal(sim.client_bottoms[0][k], v)
    for k, v in top.items():
        assert torch.equal(sim.top_params[k], v)


def test_vfl_sp_simulator_matches_jax(vfl_ref):
    from fedml_tpu_torch.simulation.sp.vertical_fl import VerticalFLSimulator
    init, ref, _ = vfl_ref
    runner, got = _port_run(VFL, init)
    assert isinstance(runner.runner, VerticalFLSimulator)
    assert runner.runner.slices == [(0, 21), (21, 42), (42, 64)]
    for p, r in zip(got["params"], ref["params"]):
        _close(p, variables_to_state_dict(r))
    assert _accs(got) == _accs(ref)


def test_vfl_session_matches_jax(vfl_ref):
    from fedml_tpu_torch.cross_silo.vertical import run_vfl_inproc
    init, ref_sp, ref = vfl_ref
    args = Arguments(**dict(VFL, training_type="cross_silo"))
    fed, _ = tdata.load(args)
    got = run_vfl_inproc(args, fed, device="cpu", init_params=init)
    assert _accs(got) == _accs(ref) == _accs(ref_sp)
    for p, r in zip(got["party_params"], ref_sp["params"]):
        _close(p, variables_to_state_dict(r))


def _free_port() -> int:
    """A base port whose ranks 0 and 1 are both free: the party listens
    on ``base + rank``, and another test's listener may hold the port
    after a free one."""
    return free_port_base(2)


@pytest.mark.parametrize("fo,server,party", [
    ("split_nn", "SplitNNServerManager", "SplitNNClientManager"),
    ("splitnn", "SplitNNServerManager", "SplitNNClientManager"),
    ("classical_vertical", "VFLServerManager", "VFLPartyManager"),
    ("vertical_fl", "VFLServerManager", "VFLPartyManager"),
    ("vfl", "VFLServerManager", "VFLPartyManager")])
def test_runner_dispatch_cross_silo(fo, server, party):
    """Each name builds its protocol's managers, both roles, over TCP on
    the CPU when asked (construction binds the rank's listener)."""
    import fedml_tpu_torch
    for role, want in (("server", server), ("client", party)):
        runner = fedml_tpu_torch.cross_silo_runner(
            role, device="cpu", backend="TCP", tcp_base_port=_free_port(),
            rank=1, party_num=2, federated_optimizer=fo,
            **{k: v for k, v in BASE.items()
               if k not in ("federated_optimizer",)})
        manager = runner.runner.manager
        assert type(manager).__name__ == want
        assert manager.device.type == "cpu"
        manager.com_manager.stop_receive_message()


@pytest.mark.parametrize("fo,name", [("SA", "secure aggregation"),
                                     ("LSA", "LightSecAgg")])
@pytest.mark.parametrize("role", ["server", "client"])
def test_secure_aggregation_still_raises(fo, name, role):
    """SA and LSA are ported: the runner dispatches them to their own
    managers over the party's transport (TCP here, as ``silo_main``
    builds a silo), on the party's device."""
    pytest.importorskip("cryptography")
    import fedml_tpu_torch
    runner = fedml_tpu_torch.cross_silo_runner(
        role, device="cpu", backend="TCP", tcp_base_port=_free_port(),
        dataset="synthetic_mnist", model="lr", client_num_in_total=2,
        client_num_per_round=2, max_total_samples=16,
        enable_tracking=False, rank=1, federated_optimizer=fo)
    manager = runner.runner.manager
    cls = {"SA": "SecAgg", "LSA": "LSA"}[fo]
    want = f"{cls}{'Server' if role == 'server' else 'Client'}Manager"
    assert type(manager).__name__ == want
    assert manager.backend == "TCP"
    if role == "server":
        assert all(v.device.type == "cpu"
                   for v in manager.global_params.values())
    else:
        assert manager.trainer.device.type == "cpu"
    manager.com_manager.stop_receive_message()


@pytest.mark.parametrize("fo,cls", [
    ("decentralized_fl", "DecentralizedSimulator"),
    ("hierarchicalfl", "HierarchicalSimulator"),
    ("split_nn", "SplitNNSimulator"),
    ("classical_vertical", "VerticalFLSimulator"),
    ("vertical_fl", "VerticalFLSimulator"),
    ("vfl", "VerticalFLSimulator")])
@pytest.mark.parametrize("backend", ["sp", "gpu"])
def test_protocol_simulators_dispatch_on_either_backend(fo, cls, backend):
    """The JAX runner dispatches the protocol simulators before it looks
    at the backend; so does the port's."""
    from fedml_tpu_torch.runner import FedMLRunner
    args = Arguments(**dict(BASE, federated_optimizer=fo, backend=backend,
                            max_total_samples=64))
    fed, od = tdata.load(args)
    runner = FedMLRunner(args, device="cpu", dataset=fed,
                         model=tmodel.create(args, od, fed.input_shape))
    assert type(runner.runner).__name__ == cls
