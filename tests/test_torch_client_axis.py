"""The GPU engine's ``client`` mesh axis over ranks (the port's counterpart of
``TPUSimulator`` on ``mesh_shape={"client": W}``), on the CPU.

The port runs W gloo rank processes (``core/launch.py::run_ranks``; they
import only torch and ``fedml_tpu_torch``); the JAX engine runs in this
process over W of the 8 virtual CPU devices. From the same flax
parameters:

* FedAvg (LR and the CNN on digits), SCAFFOLD (its ``client_states`` rows
  live on their ranks), FedSGD with ``client_slot_fold``, LDP, chaos
  dropout and oort selection (the store reads every rank's per-client
  losses) at W = 2 and 4 agree with the JAX engine within the house
  tolerance ``rtol=2e-4, atol=2e-5`` (params and history);
* every rank ends with bitwise the same params and history;
* W = 1 through the multi-rank path (a gloo group of one) equals the
  engine without a mesh bitwise;
* a run checkpointed at W = 2 resumes at W = 2 to the uninterrupted run's
  params;
* a mesh with an axis beside ``client`` (``{"client": 2, "fsdp": 2}`` on
  4 ranks) replicates the round along it, as the JAX round's shard_map
  does: FedAvg and a defended round agree with JAX on 4 devices with the
  same mesh, every rank bitwise equal (robust mode, contribution and a
  user aggregator over ranks are held in ``tests/
  test_torch_robust_ranks*.py``, async rounds in ``tests/
  test_torch_async_ranks.py``);
* a mesh with no ``client`` axis raises (the JAX engine reads the axis
  and fails too), naming it; a ``mesh_shape`` of more than one rank with
  no process group raises, naming the launch.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest

import fedml_tpu.simulation.tpu.engine as jengine
import fedml_tpu_torch
from fedml_tpu.core.mesh import build_mesh as jbuild_mesh
from fedml_tpu_torch.core.launch import run_ranks
from fedml_tpu_torch.interop import flax_to_state_dict

from torch_port_support import (ATOL, LR_BASE, RTOL, jax_init, jax_params,
                                jax_sim, single_torch_thread)  # noqa: F401

pytestmark = pytest.mark.torch_port

HERE = os.path.dirname(os.path.abspath(__file__))
SPAWN_S = 240.0

CASES = {
    "fedavg_lr": LR_BASE,
    "fedavg_cnn": dict(dataset="digits", model="cnn", client_num_in_total=8,
                       client_num_per_round=4, comm_round=2, epochs=1,
                       batch_size=16, learning_rate=0.05,
                       frequency_of_the_test=1, random_seed=1,
                       max_total_samples=256),
    "scaffold": dict(LR_BASE, federated_optimizer="SCAFFOLD"),
    "fedsgd_fold": dict(LR_BASE, federated_optimizer="fedsgd", server_lr=0.5,
                        client_num_per_round=8, client_slot_fold=True),
    "ldp": dict(LR_BASE, enable_dp=True, dp_type="local_dp", dp_epsilon=8.0,
                dp_delta=1e-5, dp_clip_norm=0.5),
    "chaos_dropout": dict(LR_BASE, chaos_dropout_prob=0.3,
                          chaos_straggler_prob=0.3, chaos_straggler_work=0.5,
                          chaos_seed=3),
    # the store selects from every client's loss: each rank's per-client
    # metrics reach every rank through the round's all-reduce
    "selection_oort": dict(LR_BASE, comm_round=4, rounds_per_dispatch=1,
                           client_selection="oort"),
}

_INIT = {}


def init_of(name):
    if name not in _INIT:
        _INIT[name] = flax_to_state_dict(jax_init(CASES[name]))
    return _INIT[name]


def ranks(target, world, **kwargs):
    return run_ranks(f"torch_rank_programs:{target}", world, kwargs,
                     timeout=SPAWN_S, sys_path=[HERE])


@pytest.fixture(scope="module")
def port_runs():
    """The port's runs of every case at W ranks, one spawn per W."""
    cache = {}

    def get(w):
        if w not in cache:
            cases = {n: (cfg, init_of(n)) for n, cfg in CASES.items()}
            cache[w] = ranks("simulate", w, cases=cases,
                             mesh_shape={"client": w})
        return cache[w]
    return get


def jax_run(cfg, w, monkeypatch):
    """``TPUSimulator`` on ``mesh_shape={"client": w}`` over the first w
    virtual devices."""
    monkeypatch.setattr(jengine, "build_mesh", lambda shape: jbuild_mesh(
        shape, devices=jax.devices()[:w]))
    sim = jax_sim(dict(cfg, mesh_shape={"client": w}))
    assert sim.n_devices == w
    return sim.run()


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_client_axis_matches_jax(port_runs, monkeypatch, case, w):
    got = port_runs(w)[0][case]
    rj = jax_run(CASES[case], w, monkeypatch)
    want = jax_params(rj["params"])
    assert set(got["params"]) == set(want)
    for k in want:
        np.testing.assert_allclose(got["params"][k], want[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert len(got["history"]) == len(rj["history"])
    for ht, hj in zip(got["history"], rj["history"]):
        for k in ("train_loss", "train_acc", "test_acc", "test_loss"):
            if k in hj:
                np.testing.assert_allclose(ht[k], hj[k], rtol=RTOL,
                                           atol=ATOL, err_msg=k)
    moved = max(float(np.abs(want[k] - init_of(case)[k]).max())
                for k in want)
    assert moved > 1e-3
    st = got["stats"]
    assert st["ranks"] == w
    # one all-reduce per round, of at least the model's floats
    assert st["allreduce_calls"] == CASES[case]["comm_round"]
    n = sum(v.size for v in want.values())
    assert st["allreduce_bytes"] >= 4 * n * st["allreduce_calls"]


@pytest.mark.parametrize("w", [2, 4])
def test_every_rank_ends_bitwise_equal(port_runs, w):
    runs = port_runs(w)
    assert len(runs) == w
    for name in CASES:
        for other in runs[1:]:
            for k, v in runs[0][name]["params"].items():
                assert np.array_equal(v, other[name]["params"][k]), (name, k)
            assert other[name]["history"] == runs[0][name]["history"], name


@pytest.mark.parametrize("case", ["fedavg_lr", "scaffold", "fedsgd_fold"])
def test_one_rank_mesh_equals_plain_engine(case):
    """``{"client": 1}`` in a group of one rank (the all-reduce runs)
    equals the engine without a mesh, bitwise, and so does ``{"client":
    1}`` with no group (no all-reduce)."""
    cfg, init = CASES[case], init_of(case)
    (got,) = ranks("simulate", 1, cases={case: (cfg, init)},
                   mesh_shape={"client": 1})
    got = got[case]
    assert got["stats"]["allreduce_calls"] == cfg["comm_round"]
    plain = fedml_tpu_torch.run_simulation(device="cpu", init_params=init,
                                           enable_tracking=False, **cfg)
    alone = fedml_tpu_torch.run_simulation(
        device="cpu", init_params=init, enable_tracking=False,
        mesh_shape={"client": 1}, **cfg)
    assert "allreduce_calls" not in alone["dispatch_stats"]
    for k, v in plain["params"].items():
        assert np.array_equal(v.numpy(), got["params"][k]), k
        assert np.array_equal(v.numpy(), alone["params"][k].numpy()), k
    assert got["history"] == plain["history"]


def test_checkpoint_at_two_ranks_resumes(tmp_path):
    """SCAFFOLD's client states are gathered to rank 0's checkpoint and
    each rank takes its rows back on resume."""
    cfg = dict(CASES["scaffold"], comm_round=4)
    out = ranks("simulate_resumed", 2, cfg=cfg, init=init_of("scaffold"),
                mesh_shape={"client": 2}, ckpt_dir=str(tmp_path / "ck"),
                split=2)
    for r in out:
        assert r["rounds"] == [2, 3]
        for k, v in r["whole"].items():
            assert np.array_equal(v, r["resumed"][k]), k
    assert sorted(os.listdir(tmp_path / "ck"))[-1] == "round_00000003.fmtpu"


#: ``{"client": 2, "fsdp": 2}``: each client rank's pair of fsdp ranks
#: runs the same clients
BESIDE = {"fedavg_lr": LR_BASE,
          "krum": dict(LR_BASE, comm_round=2, enable_defense=True,
                       defense_type="krum", byzantine_client_num=1,
                       enable_attack=True, attack_type="byzantine_flip")}


@pytest.fixture(scope="module")
def beside_runs():
    init = init_of("fedavg_lr")
    return ranks("simulate_robust", 4, mesh_shape={"client": 2, "fsdp": 2},
                 cases={n: (c, init, False) for n, c in BESIDE.items()})


@pytest.mark.parametrize("case", sorted(BESIDE))
def test_mesh_axes_beside_client_match_jax(beside_runs, monkeypatch, case):
    monkeypatch.setattr(jengine, "build_mesh", lambda shape: jbuild_mesh(
        shape, devices=jax.devices()[:4]))
    sim = jax_sim(dict(BESIDE[case], mesh_shape={"client": 2, "fsdp": 2}))
    assert sim.n_devices == 2
    rj = sim.run()
    want = jax_params(rj["params"])
    for k in want:
        np.testing.assert_allclose(beside_runs[0][case]["params"][k],
                                   want[k], rtol=RTOL, atol=ATOL, err_msg=k)
    for other in beside_runs[1:]:
        for k, v in beside_runs[0][case]["params"].items():
            assert np.array_equal(v, other[case]["params"][k]), k
    st = beside_runs[0][case]["stats"]
    assert st["ranks"] == 2 and st["allreduce_calls"] == \
        BESIDE[case]["comm_round"]


def test_out_of_scope_combinations_raise():
    """What the JAX engine refuses too: a mesh with no ``client`` axis."""
    out = ranks("refusals", 2, cases={"axes": (LR_BASE, init_of(
        "fedavg_lr"))}, mesh_shape={"data": 2})
    for got in out:
        kind, msg = got["axes"]
        assert kind == "ValueError" and "mesh_shape" in msg \
            and "'client'" in msg


def test_mesh_without_its_ranks_raises():
    """More than one rank and no process group: a ValueError that keeps
    JAX's wording and names the launch; never a quiet one-rank run."""
    with pytest.raises(ValueError) as ei:
        fedml_tpu_torch.run_simulation(device="cpu", enable_tracking=False,
                                       mesh_shape={"client": 2}, **LR_BASE)
    assert str(ei.value).startswith("mesh shape {'client': 2} != 1 devices")
    assert "torchrun --nproc_per_node 2" in str(ei.value)
