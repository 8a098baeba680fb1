"""The federated optimizer family on the port against the JAX package
(the port of ``tests/test_optimizers.py``, at tier-1 size).

Every name in the JAX registry (and FedOpt's four server optimizers, and
FedNova with momentum-SGD clients) runs 2 rounds on ``synthetic_mnist`` +
``lr`` through the port's GPU engine (on the CPU) and its SP golden loop,
from the flax parameters the JAX SP loop draws; both are held to the JAX
SP loop's final parameters and history, and to each other bitwise. Client state must persist across
rounds a client sits out: SCAFFOLD and FedDyn run 4 of 8 clients for 3
rounds.

Tolerance: the house float32 one, ``rtol=2e-4, atol=2e-5``, for every
optimizer, FedOpt's adam and yogi included: their step divides by
``sqrt(v) + eps``, which is continuous in the aggregate, so the port's and
XLA's rounding differences stay as small as the other optimizers'.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu.data as jdata
import fedml_tpu.model as jmodel
from fedml_tpu.arguments import Arguments as JArguments
from fedml_tpu.optimizers import available_optimizers as j_available
import fedml_tpu_torch
from fedml_tpu_torch.interop import flax_to_state_dict
from fedml_tpu_torch.optimizers import available_optimizers

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5

CONFIGS = {
    "FedAvg": {}, "FedProx": {}, "FedOpt": {},
    "FedOpt_adam": dict(server_optimizer="adam", server_lr=0.01),
    "FedOpt_adagrad": dict(server_optimizer="adagrad", server_lr=0.01),
    "FedOpt_yogi": dict(server_optimizer="yogi", server_lr=0.01),
    "FedSGD": {}, "FedLocalSGD": {},
    "SCAFFOLD": dict(learning_rate=0.05), "FedNova": {},
    "FedNova_momentum": dict(momentum=0.9), "FedDyn": dict(learning_rate=0.05),
    "Mime": {},
}


def make_args(name, **kw):
    base = dict(dataset="synthetic_mnist", model="lr",
                federated_optimizer=name.split("_")[0],
                client_num_in_total=8, client_num_per_round=8, comm_round=2,
                epochs=1, batch_size=32, learning_rate=0.1,
                frequency_of_the_test=2, random_seed=7, synthetic_size=600,
                synthetic_test_size=64)
    base.update(CONFIGS[name])
    base.update(kw)
    return base


def _jax_run(cfg):
    jargs = JArguments(backend="sp", **cfg)
    fed, out_dim = jdata.load(jargs)
    key = jax.random.split(jax.random.PRNGKey(cfg["random_seed"]))[0]
    p0 = jax.device_get(jmodel.create(jargs, out_dim).init(
        key, fed.train.x[0, 0]))
    rj = fedml_tpu.run_simulation(backend="sp", args=JArguments(
        backend="sp", **cfg))
    return flax_to_state_dict(p0), rj


def _assert_matches(rt, rj):
    want = flax_to_state_dict(jax.device_get(rj["params"]))
    assert set(rt["params"]) == set(want)
    for k, v in rt["params"].items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert len(rt["history"]) == len(rj["history"])
    for ht, hj in zip(rt["history"], rj["history"]):
        for k in set(hj) - {"round"}:
            np.testing.assert_allclose(ht[k], hj[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def test_available_optimizers_match_jax():
    assert available_optimizers() == j_available()


def _run_both(cfg, init, rj):
    """The port's GPU engine and SP loop, each held to the JAX SP loop,
    and to each other bitwise: the step program runs the eager loop's step
    function and both aggregate through ``WeightedSum``."""
    rt = {b: fedml_tpu_torch.run_simulation(
        backend=b, device="cpu", init_params=init, **cfg)
        for b in ("gpu", "sp")}
    for r in rt.values():
        _assert_matches(r, rj)
    for k in init:
        assert torch.equal(rt["gpu"]["params"][k], rt["sp"]["params"][k]), k
    return rt["sp"]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_optimizer_matches_jax(name):
    cfg = make_args(name)
    init, rj = _jax_run(cfg)
    rt = _run_both(cfg, init, rj)
    # the run really moved the params
    assert max(np.abs(rt["params"][k].numpy() - init[k]).max()
               for k in init) > 1e-3


@pytest.mark.parametrize("name", ["SCAFFOLD", "FedDyn"])
def test_partial_participation_keeps_client_state(name):
    """4 of 8 clients a round for 3 rounds: a client's state waits in its
    row (GPU engine) or list entry (SP) through the rounds it sits out."""
    cfg = make_args(name, client_num_per_round=4, comm_round=3,
                    frequency_of_the_test=3)
    init, rj = _jax_run(cfg)
    _run_both(cfg, init, rj)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown federated_optimizer"):
        fedml_tpu_torch.run_simulation(device="cpu", **make_args(
            "FedAvg", federated_optimizer="FedNope", comm_round=1))
