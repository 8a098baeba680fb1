"""The GPU engine's block of rounds, its step program, its FLOPs model and
its profiling plane, on the CPU.

- ``run_rounds_fused(0, R)`` equals R calls of ``run_round``, and ``run()``
  gives the same history and params whatever ``rounds_per_dispatch`` is:
  bitwise, since the rounds do the same arithmetic in the same order.
- The rounds that carry ``test_acc`` are the ones the JAX engine's
  ``TPUSimulator.run`` evaluates.
- The step program (static tensors, one body; on the CPU run eagerly)
  equals the eager loop bitwise, client after client through one program.
- ``round_cost_flops`` against the JAX engine's: the port counts one step
  with ``torch.utils.flop_counter`` (convolutions at their full padded
  extent, no elementwise op), XLA counts only the taps inside the unpadded
  input plus one FLOP per elementwise op. The padding taps weigh more on
  the CIFAR ResNets, so the port's count is above XLA's; it is held to at
  most ``FLOPS_RTOL`` = 6 % above.
- The peak table, ``mfu_value`` against the JAX package's, and the
  ``profile`` record ``obs_profile_device`` emits.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
from fedml_tpu.arguments import Arguments as JArguments
from fedml_tpu.core.algframe.client_trainer import (
    ClassificationTrainer as JTrainer)
from fedml_tpu.core.algframe.types import TrainHyper as JHyper
from fedml_tpu.core.obs import profiler as jprof
from fedml_tpu.data import load as jload
from fedml_tpu.model import create as jcreate
from fedml_tpu.optimizers.registry import create_optimizer as jcreate_opt
from fedml_tpu.simulation.tpu.engine import TPUSimulator
import fedml_tpu_torch
from fedml_tpu_torch import data as tdata
from fedml_tpu_torch import model as tmodel
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.core.algframe import client_trainer as tct
from fedml_tpu_torch.core.algframe.local_training import (StepProgram,
                                                          batch_real_of,
                                                          run_local_sgd)
from fedml_tpu_torch.core.algframe.types import ClientData, TrainHyper
from fedml_tpu_torch.core.obs import metrics as tmetrics
from fedml_tpu_torch.core.obs import profiler as tprof
from fedml_tpu_torch.core.obs import sink
from fedml_tpu_torch.model.cv.resnet import CifarResNet
from fedml_tpu_torch.model.model_hub import ModelBundle
from fedml_tpu_torch.runner import FedMLRunner

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

FLOPS_RTOL = 0.06

LR = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=6,
          client_num_per_round=4, epochs=1, batch_size=16,
          learning_rate=0.1, random_seed=7, max_total_samples=400,
          synthetic_test_size=64)
RESNET = dict(dataset="synthetic_cifar10", model="resnet20",
              client_num_in_total=4, client_num_per_round=2, batch_size=8,
              learning_rate=0.05, max_total_samples=64,
              synthetic_test_size=16, random_seed=3,
              fused_conv_block="pallas")


def _sim(**cfg):
    args = fedml_tpu_torch.init(Arguments(**cfg))
    fed, out_dim = tdata.load(args)
    bundle = tmodel.create(args, out_dim, fed.input_shape)
    return FedMLRunner(args, device="cpu", dataset=fed,
                       model=bundle).runner


def _equal_params(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("cfg,n", [(LR, 3), (RESNET, 2)],
                         ids=["lr", "resnet20"])
def test_fused_block_equals_rounds_one_at_a_time(cfg, n):
    hyper = TrainHyper(learning_rate=cfg["learning_rate"], epochs=1)
    fused, single = _sim(**cfg), _sim(**cfg)
    block = fused.run_rounds_fused(0, n, hyper)
    rounds = [single.run_round(r, hyper) for r in range(n)]
    assert block == rounds
    assert all(m["local_steps"] > 0 and m["count"] > 0 for m in block)
    _equal_params(fused.params, single.params)
    assert fused.dispatch_stats["dispatches"] == 1
    assert single.dispatch_stats["dispatches"] == n
    # one step program, reused by every client of every round; no CUDA
    # graph on the CPU
    assert len(fused.programs) == 1
    assert fused.dispatch_stats["captures"] == 0


@pytest.mark.parametrize("rpd", [3, 8])
def test_rounds_per_dispatch_changes_nothing(rpd):
    cfg = dict(LR, comm_round=7, frequency_of_the_test=3)
    base = fedml_tpu_torch.run_simulation(device="cpu",
                                          rounds_per_dispatch=1, **cfg)
    got = fedml_tpu_torch.run_simulation(device="cpu",
                                         rounds_per_dispatch=rpd, **cfg)
    assert got["history"] == base["history"]
    _equal_params(got["params"], base["params"])
    # blocks end at every eval round (0, 3, 6) and hold <= rpd rounds
    want = {3: 3, 8: 3}[rpd]
    assert got["dispatch_stats"]["dispatches"] == want
    assert base["dispatch_stats"]["dispatches"] == 7


@pytest.mark.parametrize("freq", [3, -1])
def test_eval_rounds_match_jax_engine(freq):
    cfg = dict(LR, comm_round=7, frequency_of_the_test=freq)
    rj = fedml_tpu.run_simulation(backend="tpu",
                                  args=JArguments(backend="tpu", **cfg))
    rt = fedml_tpu_torch.run_simulation(device="cpu", **cfg)
    evaluated = [[h["round"] for h in r["history"] if "test_acc" in h]
                 for r in (rj, rt)]
    assert evaluated[0] == evaluated[1]
    assert evaluated[1] == ([0, 3, 6] if freq > 0 else [])
    assert [sorted(h) for h in rj["history"]] == [
        sorted(set(h) - {"local_steps", "eval_batches"})
        for h in rt["history"]]
    if freq < 0:
        assert rt["final_test_acc"] is None is rj["final_test_acc"]


def _client(n_batches, real_counts, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(n_batches, 4, 8, 8, 3).astype(np.float32)
    y = rs.randint(0, 10, (n_batches, 4)).astype(np.int32)
    mask = np.zeros((n_batches, 4), np.float32)
    for i, c in enumerate(real_counts):
        mask[i, :c] = 1.0
    return ClientData(x * mask[..., None, None, None], y, mask,
                      np.float32(mask.sum())).to(torch.device("cpu"))


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", dict(momentum=0.9, weight_decay=5e-4)),
    ("adam", {})], ids=["sgd", "sgd_momentum_wd", "adam"])
def test_step_program_equals_eager_loop(name, kw):
    """Three clients of different lengths through ONE program (its Adam
    count must restart at each client) against the eager loop per
    client."""
    bundle = ModelBundle(CifarResNet(10, 1), "resnet")
    spec = tct.ClassificationTrainer(bundle.apply)
    params = bundle.init(torch.Generator().manual_seed(0),
                         torch.device("cpu"))
    clients = [_client(3, [4, 4, 2], 1), _client(3, [4, 0, 0], 2),
               _client(3, [3, 4, 4], 3)]
    hyper = TrainHyper(learning_rate=0.05, epochs=2)
    opt = tct.make_inner_optimizer(name, hyper.learning_rate, **kw)
    program = StepProgram(spec, opt, params, clients[0])
    for i, cdata in enumerate(clients):
        real = batch_real_of(cdata.mask)
        key = np.asarray([0, i + 11], np.uint32)
        pe, se, me = run_local_sgd(spec, opt, params, cdata, key, hyper)
        pp, sp_, mp = program.run(params, cdata, key, hyper, real)
        assert se == sp_ == 2 * int(real.sum())
        _equal_params(pe, pp)
        for k in me:
            assert torch.equal(me[k], mp[k]), k
        assert max(float((pe[k] - params[k]).abs().max())
                   for k in pe) > 1e-4
    if name == "adam":
        assert float(program.opt_state["count"]) == 2 * 3
    assert program.captures == 0 and program.replays == 0


def test_round_cost_flops_matches_jax_engine():
    cfg = dict(RESNET, fused_conv_block="")
    jargs = JArguments(backend="tpu", **cfg)
    fed, out_dim = jload(jargs)
    bundle = jcreate(jargs, out_dim)
    spec = JTrainer(bundle.apply)
    jsim = TPUSimulator(jargs, fed, bundle, jcreate_opt(jargs, spec), spec)
    want = jsim.round_cost_flops(JHyper(learning_rate=jnp.float32(0.05),
                                        epochs=1))
    got = _sim(**cfg).round_cost_flops(TrainHyper(learning_rate=0.05))
    assert 0 < want < got <= want * (1 + FLOPS_RTOL)
    # the count is the same whichever kernel runs the block
    fused = _sim(**RESNET).round_cost_flops(TrainHyper(learning_rate=0.05))
    assert fused == got


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989.0), ("NVIDIA H100 PCIe", 756.0),
    ("NVIDIA A100-SXM4-80GB", None), ("cpu", 0.5)])
def test_peak_tflops(name, peak):
    assert tprof.peak_tflops(name) == peak


@pytest.mark.parametrize("flops,wall,n,peak", [
    (3.7e13, 20.0, 1, 989.0), (1e12, 0.5, 8, 275.0), (0.0, 1.0, 1, 989.0),
    (1e12, 0.0, 1, 989.0), (1e12, 2.0, 1, None)])
def test_mfu_value_matches_jax(flops, wall, n, peak):
    want = jprof.mfu_value(flops, wall, n, peak_tflops_per_chip=peak,
                           device=SimpleNamespace(device_kind="unknown card"))
    got = tprof.mfu_value(flops, wall, n, peak_tflops_per_chip=peak,
                          device="unknown card")
    assert got == want


def test_obs_profile_device_emits_profile_records():
    records = []
    sink.set_sink(records.append)
    tmetrics.REGISTRY.reset()
    try:
        r = fedml_tpu_torch.run_simulation(
            device="cpu", comm_round=2, frequency_of_the_test=-1,
            obs_profile_device=True, **LR)
    finally:
        sink.set_sink(None)
    prof = [x for x in records if x["kind"] == "profile"]
    assert len(prof) == r["dispatch_stats"]["dispatches"] == 1
    rec = prof[0]
    assert rec["dispatch"] == "rounds_fused" and rec["rounds"] == 2
    assert rec["total_s"] >= rec["host_s"] > 0
    assert rec["device_wait_s"] >= 0
    # the CPU's entry in the peak table gives an MFU, and the gauge has it
    assert rec["mfu"] > 0
    # (the record rounds it to 5 decimals)
    assert round(tmetrics.REGISTRY.gauge("fed_round_mfu").value(), 5) == \
        rec["mfu"]
    spans = [x["name"] for x in records if x["kind"] == "span"]
    assert "dispatch" in spans and "block" in spans
