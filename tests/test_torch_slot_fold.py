"""Client-slot folding on the port (the port of ``tests/test_slot_fold.py``).

``client_slot_fold: true`` folds the sampled clients into the batch axis
for optimizers whose aggregate is sample-additive at shared params
(FedSGD): one wide full-batch pass replaces the per-client passes. The
JAX engine folds each chip's slots; the port's one card folds all of
them. Exactness is the contract: the folded round equals the unfolded one
up to float summation order (bound ``rtol=1e-5, atol=1e-6``, the JAX
test's), and the JAX engine's folded round within the house tolerance
``rtol=2e-4, atol=2e-5``. A config that cannot fold refuses loudly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.data as jdata
import fedml_tpu.model as jmodel
from fedml_tpu.arguments import Arguments as JArguments
from fedml_tpu.core.algframe.client_trainer import (
    ClassificationTrainer as JTrainer)
from fedml_tpu.core.algframe.types import TrainHyper as JHyper
from fedml_tpu.optimizers.registry import create_optimizer as jcreate_opt
from fedml_tpu.simulation.tpu.engine import TPUSimulator
import fedml_tpu_torch
from fedml_tpu_torch import data as tdata
from fedml_tpu_torch import model as tmodel
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.core.algframe.types import TrainHyper
from fedml_tpu_torch.interop import flax_to_state_dict
from fedml_tpu_torch.runner import FedMLRunner

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port


def sim_args(**kw):
    base = dict(dataset="synthetic_mnist", model="lr",
                federated_optimizer="fedsgd", server_lr=0.5,
                client_num_in_total=8, client_num_per_round=8,
                comm_round=4, epochs=1, batch_size=32, learning_rate=0.1,
                frequency_of_the_test=10_000, random_seed=5,
                synthetic_size=640, synthetic_test_size=64)
    base.update(kw)
    return base


def build_sim(**kw):
    args = fedml_tpu_torch.init(Arguments(**sim_args(**kw)))
    fed, out_dim = tdata.load(args)
    bundle = tmodel.create(args, out_dim, fed.input_shape)
    return FedMLRunner(args, device="cpu", dataset=fed,
                       model=bundle).runner


HYPER = TrainHyper(learning_rate=0.1, epochs=1)


def assert_params_close(a, b, rtol=1e-5, atol=1e-6):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


class TestFoldParity:
    def test_fedsgd_round_parity(self):
        """Folded wide pass == per-client passes, round for round."""
        unfolded = build_sim()
        fold = build_sim(client_slot_fold=True)
        assert not unfolded._slot_fold and fold._slot_fold
        for r in range(3):
            m_u = unfolded.run_round(r, HYPER)
            m_f = fold.run_round(r, HYPER)
            for k in ("loss_sum", "correct", "count"):
                np.testing.assert_allclose(m_f[k], m_u[k], rtol=1e-5,
                                           err_msg=k)
        assert_params_close(unfolded.params, fold.params)
        # one wide gradient program, no step program
        assert [k[0] for k in fold.programs] == ["grad"]

    @pytest.mark.parametrize("kw", [
        {}, dict(client_num_in_total=16, client_num_per_round=8)],
        ids=["full", "partial_participation"])
    def test_fold_rides_fused_blocks(self, kw):
        """The folded round slots into the block of rounds unchanged: one
        block, the same params as the per-client rounds' block."""
        unfolded = build_sim(**kw)
        fold = build_sim(client_slot_fold=True, **kw)
        unfolded.run_rounds_fused(0, 4, HYPER)
        fold.run_rounds_fused(0, 4, HYPER)
        assert fold.dispatch_stats["dispatches"] == 1
        assert_params_close(unfolded.params, fold.params)

    def test_fold_matches_jax_folded_round(self):
        """The port's folded rounds against the JAX engine's folded rounds
        (8 virtual CPU devices, one client slot each), from the same
        flax-drawn params."""
        jargs = JArguments(**sim_args(client_slot_fold=True))
        fed, out_dim = jdata.load(jargs)
        bundle = jmodel.create(jargs, out_dim)
        spec = JTrainer(bundle.apply)
        jsim = TPUSimulator(jargs, fed, bundle, jcreate_opt(jargs, spec),
                            spec)
        assert jsim._slot_fold
        init = flax_to_state_dict(jax.device_get(jsim.params))
        jsim.run_rounds_fused(0, 3, JHyper(learning_rate=jnp.float32(0.1),
                                           epochs=1))
        r = fedml_tpu_torch.run_simulation(
            device="cpu", init_params=init,
            **sim_args(client_slot_fold=True, comm_round=3))
        assert_params_close(
            r["params"], flax_to_state_dict(jax.device_get(jsim.params)),
            rtol=2e-4, atol=2e-5)
        assert max((r["params"][k] - torch.tensor(init[k])).abs().max()
                   for k in init) > 1e-3


class TestFoldRefusals:
    def test_off_strings_stay_off(self):
        for knob in (False, "false", "0"):
            assert not build_sim(client_slot_fold=knob)._slot_fold

    def test_refuses_per_client_trajectory_optimizer(self):
        """FedAvg runs local SGD trajectories: folding would change the
        algorithm, not just the layout."""
        with pytest.raises(ValueError, match="client_slot_fold") as ei:
            build_sim(federated_optimizer="fedavg", client_slot_fold=True)
        assert "folds_client_slots" in str(ei.value)
        assert "per-client local trajectories" in str(ei.value)
