"""The port's task trainers and the new model families end to end, against
the JAX package.

* ``SequenceTrainer``, ``MultiLabelTrainer`` and ``RegressionTrainer``:
  ``loss`` / aux / ``eval_stats`` on the same logits and labels, within the
  house float32 tolerance (rtol 2e-4, atol 2e-5), and
  ``make_trainer_spec``'s task inference.
* ``fedml_tpu_torch.run_simulation(backend="gpu", device="cpu")`` against
  ``fedml_tpu.run_simulation`` from the same flax-drawn parameters: a
  2-round FedOpt run of a narrow Shakespeare LSTM on the bundled text, a
  2-round CNNFemnist run with dropout (its masks must be JAX's: the run
  could not agree otherwise) and a 2-round ``digits`` logistic regression.
  Final parameters within the house tolerance; the GPU engine equals the
  SP loop bitwise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.algframe import client_trainer as jct
from fedml_tpu_torch.core.algframe import client_trainer as tct
from fedml_tpu_torch.data import containers as tcontainers
from fedml_tpu_torch.model.model_hub import ModelBundle as TBundle

from torch_port_support import (narrow_lstm,  # noqa: F401
                                single_torch_thread, zoo_runs)

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5


def _batch(task, rs):
    bs = 6
    mask = np.ones(bs, np.float32)
    mask[-2:] = 0.0
    if task == "sequence":
        logits = rs.randn(bs, 7, 11).astype(np.float32)
        y = rs.randint(0, 11, (bs, 7)).astype(np.int32)
    elif task == "multilabel":
        logits = rs.randn(bs, 9).astype(np.float32)
        y = (rs.rand(bs, 9) < 0.3).astype(np.float32)
    else:
        logits = rs.randn(bs, 1).astype(np.float32)
        y = rs.randn(bs).astype(np.float32)
    return logits, {"x": np.zeros((bs, 1), np.float32), "y": y,
                    "mask": mask}


@pytest.mark.parametrize("task,cls", [
    ("sequence", "SequenceTrainer"), ("multilabel", "MultiLabelTrainer"),
    ("regression", "RegressionTrainer")])
def test_trainer_sums_match_jax(task, cls):
    logits, batch = _batch(task, np.random.RandomState(0))
    jspec = getattr(jct, cls)(
        lambda p, x, rng=None, train=False: jnp.asarray(logits) * p["w"])
    tspec = getattr(tct, cls)(
        lambda p, x, rng=None, train=False: torch.tensor(logits) * p["w"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    jloss, jaux = jspec.loss({"w": jnp.float32(1.0)}, jb,
                             jax.random.PRNGKey(0))
    tloss, taux = tspec.loss({"w": torch.tensor(1.0)}, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL,
                               atol=ATOL)
    for got, want in ((taux, jaux),
                      (tspec.eval_stats({"w": torch.tensor(1.0)}, tb),
                       jspec.eval_stats({"w": jnp.float32(1.0)}, jb))):
        assert set(got) == set(want) == {"loss_sum", "correct", "count"}
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    if task == "sequence":
        # every token of the 4 real samples counts, padding included
        assert float(taux["count"]) == 4 * 7
    if task == "regression":
        assert float(taux["correct"]) == 0.0
    # the gradient flows through the same sums
    w = torch.tensor(1.0, requires_grad=True)
    g_t = torch.autograd.grad(tspec.loss({"w": w}, tb)[0], w)[0]
    g_j = jax.grad(lambda w: jspec.loss({"w": w}, jb, None)[0])(
        jnp.float32(1.0))
    np.testing.assert_allclose(float(g_t), float(g_j), rtol=RTOL, atol=ATOL)


def _fed(y, task):
    x = np.zeros((4, 3), np.float32)
    return tcontainers.build_federated_dataset(
        [x, x], [y, y], x, y, batch_size=2, num_classes=3, task=task)


def test_make_trainer_spec_infers_the_task():
    """Declared tasks pick their trainer; an undeclared dataset whose
    labels carry a trailing axis is ``sequence`` (ints) or ``multilabel``
    (floats), as ``fedml_tpu``'s inference."""
    bundle = TBundle(torch.nn.Linear(3, 3), "lr")
    cases = [(np.zeros(4, np.int64), "classification", "Classification"),
             (np.zeros((4, 5), np.int32), "classification", "Sequence"),
             (np.zeros((4, 5), np.float32), "classification", "MultiLabel"),
             (np.zeros(4, np.float32), "regression", "Regression"),
             (np.zeros((4, 5), np.int32), "sequence", "Sequence"),
             (np.zeros((4, 5), np.float32), "multilabel", "MultiLabel")]
    for y, task, name in cases:
        fed = _fed(y, task)
        spec = tct.make_trainer_spec(fed, bundle)
        assert type(spec).__name__ == f"{name}Trainer", (y.shape, task)
        jspec = jct.make_trainer_spec(fed, bundle)
        assert type(jspec).__name__ == type(spec).__name__


# -- end to end ---------------------------------------------------------------

LSTM = dict(dataset="shakespeare", model="rnn", client_num_in_total=4,
            client_num_per_round=4, comm_round=2, epochs=1, batch_size=16,
            learning_rate=0.4, federated_optimizer="FedOpt",
            server_optimizer="sgd", server_lr=1.0, server_momentum=0.9,
            frequency_of_the_test=1, random_seed=0)
CNN = dict(dataset="synthetic_femnist", model="cnn", client_num_in_total=4,
           client_num_per_round=2, comm_round=2, batch_size=8,
           learning_rate=0.05, max_total_samples=48, synthetic_test_size=16,
           frequency_of_the_test=1, random_seed=3)
DIGITS = dict(dataset="digits", model="lr", client_num_in_total=10,
              client_num_per_round=10, comm_round=2, batch_size=32,
              learning_rate=0.3, frequency_of_the_test=1, random_seed=0)


def test_fedopt_lstm_on_bundled_shakespeare_matches_jax(narrow_lstm,
                                                        tmp_path):
    rt, _ = zoo_runs(LSTM, tmp_path)
    assert rt["history"][0]["local_steps"] > 0


def test_cnn_femnist_with_dropout_matches_jax(tmp_path):
    """Dropout in every local step: the masks come from each step's split
    of the client's loop key, on both sides."""
    rt, _ = zoo_runs(CNN, tmp_path)
    assert rt["history"][-1]["local_steps"] > 2


def test_digits_lr_matches_jax(tmp_path):
    zoo_runs(DIGITS, tmp_path)


def test_dropout_runs_draw_fresh_masks_per_step():
    """Same params, same batch, two steps: the masks differ between steps
    and the run is reproducible."""
    from fedml_tpu_torch.core.algframe.local_training import StepKeys
    from fedml_tpu_torch import prng
    keys = StepKeys("cpu")
    keys.reset_(prng.PRNGKey(5))
    a, b = keys.next().clone(), keys.next().clone()
    assert not torch.equal(a, b)
    # the chain is JAX's: split(split(rng)[1]) ...
    carry = jax.random.split(jax.random.PRNGKey(5))[1]
    carry, k0 = jax.random.split(carry)
    _, k1 = jax.random.split(carry)
    np.testing.assert_array_equal(a.numpy(), np.asarray(k0))
    np.testing.assert_array_equal(b.numpy(), np.asarray(k1))

