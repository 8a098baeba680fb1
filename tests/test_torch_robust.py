"""The defended round of the port's simulators (``simulation/gpu/engine.py``
robust mode, ``simulation/sp/simulator.py::_aggregate_robust``) on the CPU.

* fused ≡ host on the port at the JAX package's own tolerance
  (``rtol=1e-5, atol=1e-6``, ``tests/test_robust_fused.py``): the path
  that reads nothing back inside a block against the one that reads each
  round's verdict, params and verdicts;
* the GPU engine against the JAX package's SP loop and the port's SP loop
  against it, from the same flax parameters, on ``synthetic_mnist``/``lr``
  and on ResNet-20, at the house tolerance ``rtol=2e-4, atol=2e-5`` (the
  engine runs the one-card sharded kernels, the SP loops the host
  kernels; with deterministic attacks both give the same aggregate);
* a fused block ≡ its rounds run one at a time (bitwise);
* the refusals: extras with DP or robust mode, the slot fold with robust
  mode or DP, ``robust_fused: fused`` on an unfusable config;
* the foolsgold checkpoint: it holds ``dp`` and ``defense_state``, and a
  resumed run equals the uninterrupted one bitwise; a checkpoint with no
  ``defense_state`` restores without it;
* a defended run builds the one step program an undefended run builds.
"""

from __future__ import annotations

import logging

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu.data as jdata
import fedml_tpu.model as jmodel
from fedml_tpu.arguments import Arguments as JArguments
import fedml_tpu_torch
from fedml_tpu_torch import data as tdata
from fedml_tpu_torch import model as tmodel
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.core.algframe.types import TrainHyper
from fedml_tpu_torch.core.checkpoint import RoundCheckpointer
from fedml_tpu_torch.interop import flax_to_state_dict
from fedml_tpu_torch.runner import FedMLRunner

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
FUSED_TOL = dict(rtol=1e-5, atol=1e-6)
BASE = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=8,
            client_num_per_round=4, comm_round=3, epochs=1, batch_size=16,
            learning_rate=0.1, frequency_of_the_test=100, random_seed=7,
            max_total_samples=400)


def _sim(backend="gpu", init_params=None, **kw):
    args = Arguments(backend=backend, **dict(BASE, **kw))
    fed, out_dim = tdata.load(args)
    bundle = tmodel.create(args, out_dim, fed.input_shape)
    return FedMLRunner(args, device="cpu", dataset=fed, model=bundle,
                       init_params=init_params).runner


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _close(a, b, **tol):
    for k in b:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   **(tol or dict(rtol=RTOL, atol=ATOL)),
                                   err_msg=k)


FUSED_CASES = {
    "defense": dict(enable_defense=True, defense_type="multi_krum",
                    byzantine_client_num=1, krum_param_m=2),
    "attack_defense": dict(enable_attack=True, attack_type="byzantine_flip",
                           byzantine_client_num=2, attack_scale=3.0,
                           enable_defense=True, defense_type="trimmed_mean",
                           beta=0.25),
    "cdp": dict(enable_dp=True, dp_type="central_dp", dp_clip_norm=0.5,
                enable_defense=True, defense_type="coordinate_median"),
    "stochastic_attack": dict(enable_attack=True,
                              attack_type="byzantine_random",
                              byzantine_client_num=2, enable_defense=True,
                              defense_type="rfa"),
    "stateful": dict(enable_defense=True, defense_type="foolsgold"),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_equals_host(case):
    fused = _sim(**FUSED_CASES[case])
    host = _sim(robust_fused="host", **FUSED_CASES[case])
    assert fused.robust_fused and not host.robust_fused
    rf, rh = fused.run(), host.run()
    _close(rf["params"], rh["params"], **FUSED_TOL)
    assert sorted(fused.verdicts) == sorted(host.verdicts) == [0, 1, 2]
    for r in fused.verdicts:
        assert fused.verdicts[r][0] == host.verdicts[r][0]
        np.testing.assert_allclose(fused.verdicts[r][1],
                                   host.verdicts[r][1], **FUSED_TOL)
    # the host path ran each round as its own block; the fused path's
    # blocks end only at eval rounds (here round 0 and the last)
    assert host.dispatch_stats["dispatches"] == 3
    assert fused.dispatch_stats["dispatches"] == 2


def _jax_init(cfg):
    jargs = JArguments(backend="sp", **cfg)
    fed, out_dim = jdata.load(jargs)
    key = jax.random.split(jax.random.PRNGKey(cfg["random_seed"]))[0]
    return jax.device_get(jmodel.create(jargs, out_dim).init(
        key, fed.train.x[0, 0]))


JAX_CASES = {
    "flip_multi_krum": dict(enable_attack=True, attack_type="byzantine_flip",
                            byzantine_client_num=2, attack_scale=2.0,
                            enable_defense=True, defense_type="multi_krum",
                            krum_param_m=2),
    "label_flip_foolsgold": dict(enable_attack=True,
                                 attack_type="label_flip",
                                 byzantine_client_num=2,
                                 enable_defense=True,
                                 defense_type="foolsgold"),
    "median": dict(enable_defense=True, defense_type="coordinate_median"),
    # K = 6, f = 1: theta 4, beta 2 (at K = 4 every coordinate would be a
    # tie between two values equally far from their median)
    "zero_bulyan": dict(enable_attack=True, attack_type="byzantine_zero",
                        byzantine_client_num=1, enable_defense=True,
                        defense_type="bulyan", client_num_per_round=6),
    # tests/test_torch_e2e.py's ResNet-20 configuration (2 of 4 clients a
    # round: with all 4, plain FedAvg already drifts past the tolerance
    # from the JAX loop after 2 rounds, with or without a defense)
    "resnet20_flip_median": dict(
        dataset="synthetic_cifar10", model="resnet20", batch_size=8,
        client_num_in_total=4, client_num_per_round=2, comm_round=2,
        max_total_samples=64, synthetic_test_size=64, random_seed=3,
        learning_rate=0.05, enable_attack=True,
        attack_type="byzantine_flip", byzantine_client_num=1,
        attack_scale=0.5, enable_defense=True,
        defense_type="coordinate_median"),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_defended_run_matches_jax_sp(case):
    cfg = dict(BASE, **JAX_CASES[case])
    p0 = flax_to_state_dict(_jax_init(cfg))
    rj = fedml_tpu.run_simulation(backend="sp",
                                  args=JArguments(backend="sp", **cfg))
    want = flax_to_state_dict(jax.device_get(rj["params"]))
    fg = JAX_CASES[case].get("defense_type") == "foolsgold"
    for backend in ("sp", "gpu"):
        rt = fedml_tpu_torch.run_simulation(backend=backend, device="cpu",
                                            init_params=p0, **cfg)
        # foolsgold's logit rescale magnifies float32 rounding
        _close({k: v.numpy() for k, v in rt["params"].items()}, want,
               **(dict(rtol=1e-3, atol=1e-4) if fg else {}))
        np.testing.assert_allclose(rt["history"][-1]["train_loss"],
                                   rj["history"][-1]["train_loss"],
                                   rtol=1e-3 if fg else RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["stateful", "stochastic_attack"])
def test_fused_block_equals_rounds_one_at_a_time(case):
    hyper = TrainHyper(learning_rate=BASE["learning_rate"], epochs=1)
    block, single = _sim(**FUSED_CASES[case]), _sim(**FUSED_CASES[case])
    block.run_rounds_fused(0, 3, hyper)
    for r in range(3):
        single.run_rounds_fused(r, 1, hyper)
    _equal(block.params, single.params)
    for r in range(3):
        np.testing.assert_array_equal(block.verdicts[r][1],
                                      single.verdicts[r][1])
    if block._defense_state:
        _equal(block._defense_state, single._defense_state)


@pytest.mark.parametrize("opt", ["SCAFFOLD", "Mime", "FedNova"])
@pytest.mark.parametrize("knob", [
    dict(enable_dp=True, dp_type="local_dp"),
    dict(enable_defense=True, defense_type="krum"),
    dict(enable_attack=True, attack_type="byzantine_flip",
         byzantine_client_num=1)], ids=["dp", "defense", "attack"])
def test_extras_refused_with_dp_or_robust_mode(opt, knob):
    with pytest.raises(ValueError, match="DP cannot cover" if "enable_dp"
                       in knob else "robust aggregation defends only"):
        _sim(federated_optimizer=opt, **knob)


@pytest.mark.parametrize("knob,reason", [
    (dict(enable_defense=True, defense_type="median"),
     "robust mode needs the per-client update stack"),
    (dict(enable_dp=True, dp_type="central_dp"),
     "DP clips/noises per-client updates")], ids=["robust", "dp"])
def test_slot_fold_refused_with_robust_mode_or_dp(knob, reason):
    with pytest.raises(ValueError, match="cannot fold client slots") as ei:
        _sim(federated_optimizer="FedSGD", client_slot_fold=True, **knob)
    assert reason in str(ei.value)


def test_robust_fused_refused_on_unfusable_config():
    attack_only = dict(enable_attack=True, attack_type="byzantine_flip",
                       byzantine_client_num=1)
    for kw in (attack_only, dict(enable_defense=True, defense_type="krum",
                                 sharded_defense=False)):
        with pytest.raises(ValueError, match="cannot fuse the robust round"):
            _sim(robust_fused="fused", **kw)
        assert not _sim(**kw).robust_fused   # auto takes the host path


FG = dict(enable_defense=True, defense_type="foolsgold",
          enable_dp=True, dp_type="central_dp", dp_clip_norm=1.0,
          comm_round=4, checkpoint_every_rounds=2,
          client_num_per_round=3)


def test_foolsgold_checkpoint_round_trip_and_resume(tmp_path):
    full = _sim(checkpoint_dir=str(tmp_path / "full"), **FG)
    rf = full.run()
    _sim(checkpoint_dir=str(tmp_path / "part"), **dict(FG, comm_round=2)
         ).run()
    resumed = _sim(checkpoint_dir=str(tmp_path / "part"), **FG)
    rr = resumed.run()
    assert [h["round"] for h in rr["history"]] == [2, 3]
    _equal(rf["params"], rr["params"])
    _equal(full._defense_state, resumed._defense_state)
    assert rr["dp_epsilon_spent"] == rf["dp_epsilon_spent"]
    step, st = RoundCheckpointer(str(tmp_path / "full"), 2).latest(
        full.ckpt_state())
    assert step == 3 and {"dp", "defense_state"} <= set(st)
    _equal(st["defense_state"], full._defense_state)
    assert float(st["defense_state"]["history"].abs().sum()) > 0


def test_checkpoint_without_defense_state_restores(tmp_path, caplog):
    plain = {k: v for k, v in FG.items()
             if k not in ("enable_defense", "defense_type")}
    _sim(checkpoint_dir=str(tmp_path), **dict(plain, comm_round=2)).run()
    sim = _sim(checkpoint_dir=str(tmp_path), **FG)
    with caplog.at_level(logging.WARNING):
        r = sim.run()
    assert [h["round"] for h in r["history"]] == [2, 3]
    assert "without the defense_state leaf" in caplog.text


def test_defended_run_builds_the_same_step_program():
    """DP, attacks and defenses act between the local step and the server
    step: the defended run builds the one step program (same key, same
    warm-up and replay counts) the undefended run builds."""
    plain = _sim()
    defended = _sim(**FUSED_CASES["attack_defense"], enable_dp=True,
                    dp_type="local_dp")
    plain.run(), defended.run()
    assert list(plain.programs) == list(defended.programs)
    assert len(defended.programs) == 1
    for k in ("captures", "warmup_steps", "replays"):
        assert defended.dispatch_stats[k] == plain.dispatch_stats[k], k
