"""The whole slice: ``fedml_tpu_torch.run_simulation(backend="gpu",
device="cpu")`` against ``fedml_tpu.run_simulation(backend="tpu")`` with the
fused block's reference math on the JAX side.

A tiny FedAvg run (resnet20, synthetic_cifar10 capped to 64 uneven client
samples, 4 clients, 2 per round, 2 rounds, batch 8) starts both packages
from the same flax-drawn parameters; the port must reach the same final
parameters (house float32 tolerance) and the same test accuracy. That pins
the data split, the cohort sampling, the per-client keys, the epoch order,
the local steps, the weighted sum and the server step at once.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu.data
import fedml_tpu.model
from fedml_tpu.arguments import Arguments as JArguments
import fedml_tpu_torch
from fedml_tpu_torch.core.kernels.conv_block import fused_block
from fedml_tpu_torch.interop import flax_to_state_dict

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

CFG = dict(dataset="synthetic_cifar10", model="resnet20",
           client_num_in_total=4, client_num_per_round=2, comm_round=2,
           batch_size=8, learning_rate=0.05, max_total_samples=64,
           synthetic_test_size=64, frequency_of_the_test=1, random_seed=3)


def _jax_initial_params(cfg):
    """The parameters the JAX engine starts from: its init key is the
    first half of ``split(PRNGKey(seed))``, on one batch's input shape."""
    args = JArguments(backend="tpu", **cfg)
    fed, out_dim = fedml_tpu.data.load(args)
    bundle = fedml_tpu.model.create(args, out_dim)
    key = jax.random.split(jax.random.PRNGKey(cfg["random_seed"]))[0]
    return jax.device_get(bundle.init(key, fed.train.x[0, 0]))


@pytest.fixture(scope="module")
def jax_run():
    p0 = _jax_initial_params(CFG)
    result = fedml_tpu.run_simulation(backend="tpu",
                                      fused_conv_block="reference", **CFG)
    return p0, result


def test_fedavg_rounds_match_jax(jax_run):
    p0, rj = jax_run
    rt = fedml_tpu_torch.run_simulation(
        backend="gpu", device="cpu", init_params=flax_to_state_dict(p0),
        **CFG)
    assert rt["rounds"] == rj["rounds"] == 2
    assert len(rt["history"]) == len(rj["history"])
    for ht, hj in zip(rt["history"], rj["history"]):
        assert ht["local_steps"] > 0
        for k in ("train_loss", "train_acc", "test_acc", "test_loss"):
            np.testing.assert_allclose(ht[k], hj[k], rtol=2e-4, atol=2e-5,
                                       err_msg=k)
    assert rt["final_test_acc"] == rj["final_test_acc"]
    want = flax_to_state_dict(jax.device_get(rj["params"]))
    start = flax_to_state_dict(p0)
    assert set(rt["params"]) == set(want)
    for k, v in rt["params"].items():
        assert v.device.type == "cpu" and v.dtype == torch.float32
        np.testing.assert_allclose(v.numpy(), want[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)
    assert max(float(np.abs(want[k] - start[k]).max()) for k in want) > 1e-3


def test_pallas_knob_threads_through_on_cpu(jax_run):
    """``fused_conv_block="pallas"`` reaches every <= 64-channel block; on
    CPU tensors the wrapper takes the plain version inside the autograd
    Function (no kernel launch), so the run matches the JAX run too."""
    p0, rj = jax_run
    launches = fused_block.launches
    rt = fedml_tpu_torch.run_simulation(
        backend="gpu", device="cpu", init_params=flax_to_state_dict(p0),
        fused_conv_block="pallas", **CFG)
    assert fused_block.launches == launches
    assert rt["final_test_acc"] == rj["final_test_acc"]
    want = flax_to_state_dict(jax.device_get(rj["params"]))
    for k, v in rt["params"].items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_fresh_init_is_seeded_and_runs():
    """Without ``init_params`` the port draws its own parameters from a
    torch.Generator seeded by ``random_seed``: two runs agree exactly."""
    cfg = dict(CFG, comm_round=1, max_total_samples=16)
    a = fedml_tpu_torch.run_simulation(device="cpu", **cfg)
    b = fedml_tpu_torch.run_simulation(device="cpu", **cfg)
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    assert np.isfinite(a["history"][0]["train_loss"])
    assert a["wall_time_s"] > 0


@pytest.mark.parametrize("knob,value", [
    ("enable_secure_agg", True), ("enable_fhe", True),
    ("mesh_shape", {"client": 2}), ("obs_roofline", True)])
def test_unported_knobs_raise(knob, value):
    cfg = dict(CFG, comm_round=1, max_total_samples=16, **{knob: value})
    if knob in ("enable_secure_agg", "enable_fhe"):
        # ported, accepted and inert as in the JAX package (secure
        # aggregation is federated_optimizer SA / LSA): the run equals
        # one with the knob off, bitwise
        on = fedml_tpu_torch.run_simulation(device="cpu", **cfg)
        off = fedml_tpu_torch.run_simulation(device="cpu",
                                             **dict(cfg, **{knob: False}))
        for k, v in off["params"].items():
            assert torch.equal(v, on["params"][k]), k
        return
    if knob == "obs_roofline":
        # ported: the run emits its round program's roofline record and
        # trains the params of a run with the knob off, bitwise
        from fedml_tpu_torch.core.obs import roofline, sink
        recs = []
        sink.set_sink(recs.append)
        try:
            on = fedml_tpu_torch.run_simulation(device="cpu", **cfg)
        finally:
            sink.set_sink(None)
        off = fedml_tpu_torch.run_simulation(device="cpu",
                                             **dict(cfg, obs_roofline=False))
        rec = [r for r in recs if r["kind"] == "roofline"]
        assert rec and rec[0]["program"] in ("round", "rounds_fused")
        assert rec[0]["total_flops"] > 0 and rec[0]["static_only"]
        assert roofline.report(rec[0]["program"]) is not None
        for k, v in off["params"].items():
            assert torch.equal(v, on["params"][k]), k
        return
    assert knob == "mesh_shape"
    # ported: the client axis over ranks. {"client": 1} in one process is
    # the engine without a mesh, bitwise; more ranks than the process has
    # raise (keeping JAX's wording), naming the launch
    one = fedml_tpu_torch.run_simulation(
        device="cpu", **dict(cfg, mesh_shape={"client": 1}))
    off = fedml_tpu_torch.run_simulation(device="cpu",
                                         **dict(cfg, mesh_shape=None))
    for k, v in off["params"].items():
        assert torch.equal(v, one["params"][k]), k
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2") \
            as ei:
        fedml_tpu_torch.run_simulation(device="cpu", **cfg)
    assert str(ei.value).startswith("mesh shape {'client': 2} != 1 devices")


@pytest.mark.parametrize("knob,value", [
    ("chaos_dropout_prob", 0.2), ("chaos_straggler_prob", 0.1),
    ("chaos_crash_at_round", 5), ("chaos_over_sample", 0.5),
    ("client_selection", "oort"), ("contribution_method", "loo"),
    ("pacer_adapt_cohort", True), ("selection_adaptive_oversample", True),
    ("robust_relayout_quant", "int8")])
def test_fault_and_selection_knobs_are_ported(knob, value):
    """The knobs of chaos, selection, contribution and the quantized
    relayout run on the GPU engine (and, where the JAX SP loop has the
    feature, on the SP loop)."""
    cfg = dict(CFG, dataset="synthetic_mnist", model="lr", comm_round=1,
               max_total_samples=64, **{knob: value})
    r = fedml_tpu_torch.run_simulation(device="cpu", **cfg)
    assert np.isfinite(r["history"][0]["train_loss"])
    if not knob.startswith("chaos_"):
        r = fedml_tpu_torch.run_simulation(backend="sp", device="cpu", **cfg)
        assert np.isfinite(r["history"][0]["train_loss"])


@pytest.mark.parametrize("knob,value", [
    ("chaos_link_loss_prob", 0.2), ("chaos_link_dup_prob", 0.2),
    ("chaos_link_delay_prob", 0.2)])
def test_link_fault_knobs_are_ported(knob, value):
    """The three ``chaos_link_*`` knobs are ported with the transport
    interceptor (cross-silo sessions: tests/test_torch_cross_silo.py). As
    in the JAX package they act on the cross-silo wire only: a simulation
    that carries one runs, bitwise equal to the same run without it."""
    cfg = dict(CFG, dataset="synthetic_mnist", model="lr", comm_round=1,
               max_total_samples=32)
    a = fedml_tpu_torch.run_simulation(device="cpu", **cfg)
    b = fedml_tpu_torch.run_simulation(device="cpu", **cfg, **{knob: value})
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k


SERVING_CHAOS_KNOBS = [
    ("chaos_serving_stall_prob", 0.1), ("chaos_serving_stall_s", 0.5),
    ("chaos_serving_stall_at_step", 3), ("chaos_serving_nan_prob", 0.1),
    ("chaos_serving_nan_at_step", 2), ("chaos_serving_conn_drop_prob", 0.1),
    ("chaos_serving_crash_at_request", 1)]


@pytest.mark.parametrize("knob,value", SERVING_CHAOS_KNOBS)
def test_serving_chaos_knobs_are_ported(knob, value):
    """The seven ``chaos_serving_*`` knobs are ported (serving chaos:
    tests/test_torch_serving_chaos.py). As in the JAX package they act on
    the serving plane only: a simulation that carries one runs, bitwise
    equal to the same run without it."""
    cfg = dict(CFG, dataset="synthetic_mnist", model="lr", comm_round=1,
               max_total_samples=32)
    a = fedml_tpu_torch.run_simulation(device="cpu", **cfg)
    b = fedml_tpu_torch.run_simulation(device="cpu", **cfg, **{knob: value})
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    from fedml_tpu_torch.arguments import Arguments
    assert getattr(Arguments(**{knob: value}), knob) == value


@pytest.mark.parametrize("knob,value", [
    ("enable_dp", True), ("enable_dp_ldp", True), ("enable_attack", True),
    ("enable_defense", True), ("robust_fused", "host")])
def test_trust_knobs_are_ported(knob, value):
    """The knobs of DP, attacks, defenses and the defended round run (on
    their own they switch nothing on but DP's default LDP frame)."""
    cfg = dict(CFG, comm_round=1, max_total_samples=16, **{knob: value})
    r = fedml_tpu_torch.run_simulation(device="cpu", **cfg)
    assert np.isfinite(r["history"][0]["train_loss"])
    assert ("dp_epsilon_spent" in r) == (knob == "enable_dp")
