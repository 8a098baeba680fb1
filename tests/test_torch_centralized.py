"""The port's centralized trainer against the JAX package's.

The pooled batch stream equals the JAX trainer's array for array; from
the JAX trainer's initial parameters both train the same epochs (plain
SGD for 1 epoch; momentum carried over 2 epochs), and their histories
and parameters agree within the house tolerance (rtol 2e-4, atol 2e-5),
the accuracies exactly. The trainer's one path, the step program
(captured on a card, eager on the CPU), equals the step body run by hand
bitwise, the momentum carried from epoch to epoch included.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from fedml_tpu import data as jdata
from fedml_tpu.arguments import Arguments as JArgs
from fedml_tpu_torch import data as tdata
from fedml_tpu_torch import model as tmodel
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.interop import flax_to_state_dict

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
BASE = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=4,
            client_num_per_round=4, comm_round=1, epochs=1, batch_size=32,
            learning_rate=0.1, frequency_of_the_test=1, random_seed=11,
            max_total_samples=300, federated_optimizer="centralized",
            enable_tracking=False)


def _jax(cfg):
    from fedml_tpu.centralized import CentralizedTrainer
    from fedml_tpu.model import create
    args = JArgs(**cfg)
    fed, od = jdata.load(args)
    trainer = CentralizedTrainer(args, fed, create(args, od))
    init = flax_to_state_dict(jax.device_get(trainer.params))
    return trainer, init, trainer.run()


def _port(cfg, init):
    from fedml_tpu_torch.centralized import CentralizedTrainer
    from fedml_tpu_torch.runner import FedMLRunner
    args = Arguments(**cfg)
    fed, od = tdata.load(args)
    runner = FedMLRunner(args, device="cpu", dataset=fed,
                         model=tmodel.create(args, od, fed.input_shape),
                         init_params=init)
    assert isinstance(runner.runner, CentralizedTrainer)
    return runner.runner, runner.run()


@pytest.mark.parametrize("cfg", [
    BASE, dict(BASE, momentum=0.9, comm_round=2)],
    ids=["sgd_1_epoch", "momentum_2_epochs"])
def test_centralized_matches_jax(cfg):
    jt, init, ref = _jax(cfg)
    trainer, got = _port(cfg, init)
    for k in ("x", "y", "mask"):
        np.testing.assert_array_equal(trainer.data.__dict__[k].numpy(),
                                      np.asarray(getattr(jt.data, k)))
    assert float(trainer.data.num_samples) == float(jt.data.num_samples)
    assert got["rounds"] == ref["rounds"] == cfg["comm_round"]
    for hp, hr in zip(got["history"], ref["history"]):
        assert sorted(hp) == sorted(hr)
        assert hp["epoch"] == hr["epoch"] and \
            hp.get("test_acc") == hr.get("test_acc")
        np.testing.assert_allclose([hp["train_loss"], hp["train_acc"]],
                                   [hr["train_loss"], hr["train_acc"]],
                                   rtol=RTOL, atol=ATOL)
    want = flax_to_state_dict(jax.device_get(ref["params"]))
    for k, v in want.items():
        np.testing.assert_allclose(got["params"][k].numpy(), v, rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_step_program_path_equals_eager_loop():
    """The trainer's one path (a StepProgram, eager on the CPU, the card's
    path without the capture; its optimizer state kept across epochs)
    against the step body run eagerly by hand over the same batch
    schedule, the momentum carried from epoch to epoch: bitwise."""
    import torch

    from fedml_tpu_torch import prng
    from fedml_tpu_torch.core.algframe import local_training as lt
    from fedml_tpu_torch.core.algframe.types import TrainHyper
    cfg = dict(BASE, model="mlp", momentum=0.9, comm_round=3)
    _, got = _port(cfg, None)
    t, _ = _port(dict(cfg, comm_round=0), None)
    params = {k: v.clone() for k, v in t.params.items()}
    state = t.inner.init(params)
    cpu = torch.device("cpu")
    keys = lt._keys(lt.StepKeys, t.spec, cpu)
    hyper = TrainHyper(learning_rate=t.lr, epochs=1)
    for e in range(3):
        rng = prng.fold_in(t.rng, e)
        if keys is not None:
            keys.reset_(rng)
        metrics = lt._zero_metrics(cpu)
        for idx in lt._batch_schedule(rng, t.batch_real,
                                      lt.step_count(t.batch_real, hyper)):
            batch = {k: getattr(t.data, k)[idx] for k in ("x", "y", "mask")}
            lt._sgd_step(t.spec, t.inner, params, state, batch, metrics,
                         None, None, keys)
        cnt = max(float(metrics["count"]), 1.0)
        assert got["history"][e]["train_loss"] == \
            float(metrics["loss_sum"]) / cnt
    for k, v in params.items():
        assert got["params"][k].equal(v), k
