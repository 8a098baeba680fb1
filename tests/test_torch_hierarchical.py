"""The port's hierarchical FL against the JAX package's.

* The SP ``HierarchicalSimulator`` (``federated_optimizer:
  hierarchicalfl``: 2 groups, 2 edge rounds, 3 of 4 clients sampled)
  equals the JAX one after 2 rounds, the JAX init carried across, house
  tolerance, per-round accuracies equal.
* The hierarchical cross-silo session (``scenario: hierarchical``, 2
  silos of 1 rank) equals the port's horizontal session bit for bit: a
  one-rank silo is the horizontal silo, captured step and all.
* A silo of 2 gloo ranks (two processes, ``init_silo_process_group``)
  equals the 1-rank step on the same batches, house tolerance: a batch of
  16 is split 8 + 8 and its gradient all-reduced; a batch of 15 does not
  divide by 2 and is replicated.
* ``init_silo_process_group`` is a no-op at world size 1.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from fedml_tpu_torch import data as tdata
from fedml_tpu_torch import model as tmodel
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.interop import flax_to_state_dict

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_silo_worker.py")
HIER = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=4,
            client_num_per_round=3, comm_round=2, epochs=1, batch_size=16,
            learning_rate=0.1, frequency_of_the_test=1, random_seed=3,
            max_total_samples=256, federated_optimizer="hierarchicalfl",
            group_num=2, group_comm_round=2, enable_tracking=False)
SILO = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=2,
            client_num_per_round=2, comm_round=2, epochs=1, batch_size=16,
            learning_rate=0.1, frequency_of_the_test=1, random_seed=7,
            max_total_samples=128, training_type="cross_silo",
            enable_tracking=False)


def _port_parts(cfg):
    args = Arguments(**cfg)
    fed, od = tdata.load(args)
    return args, fed, tmodel.create(args, od, fed.input_shape)


def test_sp_simulator_matches_jax():
    from fedml_tpu import data as jdata
    from fedml_tpu import model as jmodel
    from fedml_tpu.arguments import Arguments as JArgs
    from fedml_tpu.runner import FedMLRunner as JRunner
    from fedml_tpu_torch.runner import FedMLRunner
    from fedml_tpu_torch.simulation.sp.hierarchical import \
        HierarchicalSimulator
    jargs = JArgs(**HIER)
    jfed, od = jdata.load(jargs)
    jbundle = jmodel.create(jargs, od)
    key = jax.random.split(jax.random.PRNGKey(HIER["random_seed"]))[0]
    init = flax_to_state_dict(jax.device_get(jbundle.init(
        key, jfed.train.x[0, 0])))
    ref = JRunner(jargs, dataset=jfed, model=jbundle).run()
    args, fed, bundle = _port_parts(HIER)
    runner = FedMLRunner(args, device="cpu", dataset=fed, model=bundle,
                         init_params=init)
    assert isinstance(runner.runner, HierarchicalSimulator)
    got = runner.run()
    want = flax_to_state_dict(jax.device_get(ref["params"]))
    for k in want:
        np.testing.assert_allclose(got["params"][k].numpy(), want[k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert [h["test_acc"] for h in got["history"]] == \
        [h["test_acc"] for h in ref["history"]]


def test_session_equals_horizontal_bitwise():
    import fedml_tpu_torch
    from fedml_tpu_torch.cross_silo.hierarchical import \
        run_hierarchical_cross_silo_inproc
    from fedml_tpu_torch.cross_silo.hierarchical.runner import \
        HierarchicalCrossSiloRunner
    from fedml_tpu_torch.cross_silo.hierarchical.trainer import \
        HierarchicalSiloTrainer
    from fedml_tpu_torch.cross_silo.horizontal.runner import \
        run_cross_silo_inproc
    args, fed, bundle = _port_parts(dict(SILO, scenario="hierarchical"))
    got = run_hierarchical_cross_silo_inproc(args, fed, bundle, device="cpu")
    args, fed, bundle = _port_parts(SILO)
    ref = run_cross_silo_inproc(args, fed, bundle, device="cpu")
    for k, v in ref["params"].items():
        assert torch.equal(got["params"][k], v), k
    assert got["history"] == ref["history"]
    # the runner builds the hierarchical silo for scenario: hierarchical
    runner = fedml_tpu_torch.cross_silo_runner(
        "client", device="cpu", backend="INPROC", scenario="hierarchical",
        inproc_broker=args.inproc_broker, rank=1,
        **{k: v for k, v in SILO.items() if k != "training_type"})
    assert isinstance(runner.runner, HierarchicalCrossSiloRunner)
    assert isinstance(runner.runner.manager.trainer, HierarchicalSiloTrainer)
    assert runner.runner.manager.trainer.world == 1
    runner.runner.manager.com_manager.stop_receive_message()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("batch_size", [16, 15], ids=["split", "replicated"])
def test_two_gloo_ranks_equal_one_rank(tmp_path, batch_size):
    from fedml_tpu_torch.core.algframe.client_trainer import \
        make_trainer_spec
    from fedml_tpu_torch.cross_silo.hierarchical import \
        HierarchicalSiloTrainer
    from fedml_tpu_torch.optimizers.registry import create_optimizer
    cfg = dict(SILO, batch_size=batch_size, federated_optimizer="FedProx",
               fedprox_mu=0.1)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    out = tmp_path / "out.npz"
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONSTARTUP",)}
    env.update(PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(cfg_path), str(out)],
        env=dict(env, RANK=str(r)), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    got = np.load(out)
    # the same trainings on one rank in this process
    args, fed, bundle = _port_parts(cfg)
    spec = make_trainer_spec(fed, bundle)
    trainer = HierarchicalSiloTrainer(args, fed, bundle, spec,
                                      create_optimizer(args, spec), "cpu")
    assert trainer.world == 1
    params = trainer.params_template
    for rnd, cid in ((0, 0), (1, 1)):
        params, _, metrics = trainer.train(params, cid, rnd)
        for k, v in params.items():
            np.testing.assert_allclose(got[f"r{rnd}.{k}"], v.numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(got[f"r{rnd}.train_loss"],
                                   metrics["train_loss"], rtol=RTOL)


def test_process_group_is_a_no_op_at_world_size_one(monkeypatch):
    import torch.distributed as dist
    from fedml_tpu_torch.cross_silo.hierarchical import \
        init_silo_process_group
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_silo_process_group() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert init_silo_process_group() is False
    assert init_silo_process_group(num_hosts=1, host_rank=0) is False
    assert not dist.is_initialized()
