"""The new model families and tasks end to end through
``fedml_tpu_torch.run_simulation`` on the CPU (GPU engine and SP loop)
against ``fedml_tpu.run_simulation``, from the same flax-drawn
parameters: final parameters and every round's metrics within the house
float32 tolerance (rtol 2e-4, atol 2e-5), the GPU engine bitwise equal to
the SP loop. Covers the multilabel, LEAF-style synthetic, real tabular and
``digits`` sets, the CNNs, ResNet-18, the next-token ``sequences`` task and
a ``regression`` dataset (which no loader declares, in either package).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

import fedml_tpu
import fedml_tpu.model as jmodel
import fedml_tpu_torch.model as tmodel
from fedml_tpu_torch.data import containers as tcontainers
from fedml_tpu_torch.interop import flax_to_state_dict

from torch_port_support import (RTOL, ATOL, assert_params_close,
                                assert_params_equal, narrow_lstm,  # noqa: F401
                                single_torch_thread, zoo_runs)

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("cfg", [
    dict(dataset="synthetic_multilabel", model="lr", learning_rate=0.5,
         max_total_samples=160),
    dict(dataset="synthetic_0.5_0.5", model="lr"),
    dict(dataset="wine", model="lr", learning_rate=0.3),
    dict(dataset="breast_cancer", model="mlp"),
    dict(dataset="digits", model="device_cnn", max_total_samples=160),
    dict(dataset="synthetic_cifar10", model="simple_cnn",
         max_total_samples=64, synthetic_test_size=16),
    dict(dataset="digits", model="resnet18", max_total_samples=48,
         comm_round=1, client_num_per_round=2, batch_size=8,
         learning_rate=0.05),
], ids=["multilabel_lr", "synthetic_ab_lr", "wine_lr", "breast_cancer_mlp",
        "digits_device_cnn", "cifar_simple_cnn", "digits_resnet18"])
def test_new_paths_match_jax(tmp_path, cfg):
    base = dict(client_num_in_total=4, client_num_per_round=4, comm_round=2,
                batch_size=16, learning_rate=0.1, frequency_of_the_test=1,
                random_seed=1)
    zoo_runs(dict(base, **cfg), tmp_path)


def test_sequences_lstm_matches_jax(narrow_lstm, tmp_path):
    zoo_runs(dict(dataset="sequences", model="rnn", client_num_in_total=4,
                  client_num_per_round=2, comm_round=2, batch_size=16,
                  learning_rate=0.5, frequency_of_the_test=1,
                  random_seed=0), tmp_path)


def test_regression_task_matches_jax():
    """No loader declares regression (nor does the JAX package's): a
    dataset built with task="regression" through each package's
    FedMLRunner, from the same params; GPU engine and SP loop alike."""
    from fedml_tpu.data.containers import build_federated_dataset as jbuild
    from fedml_tpu.runner import FedMLRunner as JRunner
    from fedml_tpu_torch.arguments import Arguments as TArguments
    from fedml_tpu_torch.runner import FedMLRunner as TRunner

    rs = np.random.RandomState(0)
    w = rs.randn(6).astype(np.float32)
    cxs = [rs.randn(n, 6).astype(np.float32) for n in (20, 13, 27)]
    cys = [x @ w + 0.1 * rs.randn(len(x)).astype(np.float32) for x in cxs]
    tx = rs.randn(30, 6).astype(np.float32)
    ty = tx @ w
    cfg = dict(model="lr", client_num_in_total=3, client_num_per_round=3,
               comm_round=2, batch_size=8, learning_rate=0.05,
               frequency_of_the_test=1, random_seed=2)
    jargs = fedml_tpu.init(None, backend="tpu", **cfg)
    jargs.training_type = "simulation"
    jfed = jbuild(cxs, cys, tx, ty, 8, 1, task="regression")
    jb = jmodel.create(jargs, 1)
    key = jax.random.split(jax.random.PRNGKey(2))[0]
    p0 = flax_to_state_dict(jax.device_get(jb.init(key, jfed.train.x[0, 0])))
    rj = JRunner(jargs, dataset=jfed, model=jb).run()
    runs = {}
    for backend in ("gpu", "sp"):
        targs = TArguments(backend=backend, **cfg)
        targs.training_type = "simulation"
        tfed = tcontainers.build_federated_dataset(cxs, cys, tx, ty, 8, 1,
                                                   task="regression")
        tb = tmodel.create(targs, 1, tfed.input_shape)
        runner = TRunner(targs, device="cpu", dataset=tfed, model=tb,
                         init_params=p0)
        assert type(runner.runner.spec).__name__ == "RegressionTrainer"
        runs[backend] = runner.run()
    assert_params_close(runs["gpu"]["params"],
                        flax_to_state_dict(jax.device_get(rj["params"])))
    assert_params_equal(runs["gpu"]["params"], runs["sp"]["params"])
    np.testing.assert_allclose(runs["gpu"]["final_test_loss"],
                               rj["final_test_loss"], rtol=RTOL, atol=ATOL)
    assert runs["gpu"]["final_test_acc"] == 0.0
