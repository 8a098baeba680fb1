"""Round checkpoints of the port (``core/checkpoint.py``) for the ``sp``
and ``gpu`` backends: the port of ``tests/test_checkpoint.py``, SCAFFOLD's
per-client control variates included.

A run interrupted at round k and resumed must end with the exact params
of an uninterrupted run: determinism makes this testable bitwise, through
fused blocks too (a checkpoint round ends a block). Against the JAX
package, whose checkpoints are orbax and not the port's codec files, the
resumed params are held to the house tolerance ``rtol=2e-4, atol=2e-5``
from the same start.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu.data
import fedml_tpu.model
from fedml_tpu.arguments import Arguments as JArguments
import fedml_tpu_torch
from fedml_tpu_torch import data as tdata
from fedml_tpu_torch import model as tmodel
from fedml_tpu_torch.arguments import Arguments as TArguments
from fedml_tpu_torch.core.algframe.types import TrainHyper
from fedml_tpu_torch.core.checkpoint import RoundCheckpointer
from fedml_tpu_torch.core.obs import metrics as obs_metrics
from fedml_tpu_torch.interop import flax_to_state_dict
from fedml_tpu_torch.runner import FedMLRunner

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
BASE = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=8,
            client_num_per_round=8, comm_round=4, epochs=1, batch_size=32,
            learning_rate=0.1, frequency_of_the_test=2, random_seed=11,
            checkpoint_every_rounds=2)
FUSED = dict(frequency_of_the_test=100, checkpoint_every_rounds=3,
             comm_round=8)


def _run(backend, ckpt_dir, **kw):
    return fedml_tpu_torch.run_simulation(
        backend=backend, device="cpu",
        **dict(BASE, checkpoint_dir=str(ckpt_dir), **kw))


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("backend", ["sp", "gpu"])
@pytest.mark.parametrize("kw,stop", [({}, 2), (FUSED, 4)])
def test_resume_matches_uninterrupted(tmp_path, backend, kw, stop):
    full = _run(backend, tmp_path / "full", **kw)
    _run(backend, tmp_path / "part", **dict(kw, comm_round=stop))
    resumed = _run(backend, tmp_path / "part", **kw)
    _equal(full["params"], resumed["params"])
    every = kw.get("checkpoint_every_rounds", 2)
    first = (stop // every) * every
    assert [h["round"] for h in resumed["history"]] == list(
        range(first, kw.get("comm_round", 4)))
    assert resumed["final_test_acc"] == full["final_test_acc"]


@pytest.mark.parametrize("backend", ["sp", "gpu"])
def test_scaffold_resume_restores_client_states(tmp_path, backend):
    """SCAFFOLD with 3 of 8 clients a round: the checkpoint holds every
    client's ``c_i`` (also of the clients that sat the rounds out), and a
    resumed run equals an uninterrupted one bitwise."""
    kw = dict(federated_optimizer="SCAFFOLD", learning_rate=0.05,
              client_num_per_round=3, frequency_of_the_test=100)
    full = _run(backend, tmp_path / "full", **kw)
    _run(backend, tmp_path / "part", **dict(kw, comm_round=2))
    sim = _gpu_sim(tmp_path / "part", backend, **kw)
    resumed = sim.run()
    _equal(full["params"], resumed["params"])
    assert [h["round"] for h in resumed["history"]] == [2, 3]
    ck = RoundCheckpointer(str(tmp_path / "full"), 2)
    step, st = ck.latest(_gpu_sim(tmp_path / "other", backend,
                                  **kw).ckpt_state())
    assert step == 3
    # the GPU engine stacks the states [clients, ...]; SP keeps a list
    states = st["client_states"]
    rows = (list(states) if backend == "sp" else
            [{"c_i": {k: v[i] for k, v in states["c_i"].items()}}
             for i in range(BASE["client_num_in_total"])])
    assert len(rows) == BASE["client_num_in_total"]
    # clients that trained carry a nonzero control variate
    assert max(float(v.abs().max()) for r in rows
               for v in r["c_i"].values()) > 0
    for i, r in enumerate(rows):
        want = (sim.client_states[i] if backend == "sp" else
                {"c_i": {k: v[i] for k, v in
                         sim.client_states["c_i"].items()}})
        _equal(r["c_i"], want["c_i"])


def test_checkpoint_rounds_end_fused_blocks(tmp_path):
    r = _run("gpu", tmp_path, **dict(FUSED, rounds_per_dispatch=8))
    # blocks end at round 0 (eval), 2 and 5 (checkpoints) and 7 (the
    # last); without checkpoints: 0 and 7
    assert r["dispatch_stats"]["dispatches"] == 4
    r = _run("gpu", tmp_path / "off", **dict(FUSED, rounds_per_dispatch=8,
                                              checkpoint_every_rounds=0))
    assert r["dispatch_stats"]["dispatches"] == 2
    ck = RoundCheckpointer(str(tmp_path), 3)
    assert ck.steps() == [2, 5]


def test_resumed_params_match_jax(tmp_path):
    """JAX resumes from its orbax checkpoint, the port from its own; both
    from the same initial params."""
    args = JArguments(backend="tpu", **dict(BASE, checkpoint_dir=None))
    fed, out_dim = fedml_tpu.data.load(args)
    key = jax.random.split(jax.random.PRNGKey(BASE["random_seed"]))[0]
    p0 = jax.device_get(fedml_tpu.model.create(args, out_dim).init(
        key, fed.train.x[0, 0]))

    def jrun(**kw):
        return fedml_tpu.run_simulation(
            backend="tpu", args=JArguments(**dict(
                BASE, checkpoint_dir=str(tmp_path / "j"), **kw)))

    jrun(comm_round=2)
    rj = jrun()
    init = flax_to_state_dict(p0)
    _run("gpu", tmp_path / "t", comm_round=2, init_params=init)
    rt = _run("gpu", tmp_path / "t", init_params=init)
    want = flax_to_state_dict(jax.device_get(rj["params"]))
    for k, v in rt["params"].items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_keeps_the_three_newest(tmp_path):
    r = _run("sp", tmp_path, comm_round=6, checkpoint_every_rounds=1)
    ck = RoundCheckpointer(str(tmp_path), 1)
    assert ck.steps() == [3, 4, 5]
    assert sorted(os.listdir(tmp_path)) == [
        f"round_{i:08d}.fmtpu" for i in (3, 4, 5)]
    step, st = ck.latest({"params": r["params"], "server_state": {},
                          "rng": np.zeros(2, np.uint32)})
    assert step == 5
    _equal(st["params"], r["params"])


def _gpu_sim(ckpt_dir, backend="gpu", **kw):
    args = TArguments(backend=backend, **dict(
        BASE, checkpoint_dir=str(ckpt_dir), **kw))
    fed, out_dim = tdata.load(args)
    bundle = tmodel.create(args, out_dim, fed.input_shape)
    return FedMLRunner(args, device="cpu", dataset=fed,
                       model=bundle).runner


def test_restore_after_capture_step(tmp_path):
    """The step program built by ``capture_step`` before ``run`` restores
    takes the restored params at its next client."""
    full = _run("gpu", tmp_path / "full")
    _run("gpu", tmp_path / "part", comm_round=2)
    sim = _gpu_sim(tmp_path / "part")
    sim.capture_step(TrainHyper(learning_rate=BASE["learning_rate"]))
    assert len(sim.programs) == 1
    resumed = sim.run()
    _equal(full["params"], resumed["params"])


def test_snapshot_is_taken_at_maybe_save(tmp_path):
    """The writer thread writes the state as it was when ``maybe_save``
    returned, not as a later round left the same tensors."""
    ck = RoundCheckpointer(str(tmp_path), every_rounds=2)
    assert not RoundCheckpointer(None, 2).enabled
    assert not RoundCheckpointer(str(tmp_path / "off"), 0).enabled
    assert not os.path.exists(tmp_path / "off")
    w = torch.arange(6, dtype=torch.float32)
    state = {"params": {"w": w}, "server_state": {},
             "rng": np.array([1, 2], np.uint32)}
    assert not ck.maybe_save(0, state)
    hist = obs_metrics.REGISTRY.histogram(
        "fed_checkpoint_flush_seconds", buckets=obs_metrics.WALL_BUCKETS)

    def flushes():
        return sum(e["count"] for e in hist.snapshot())

    n0 = flushes()
    assert ck.maybe_save(1, state)
    w.add_(100.0)        # the next round rewrites the tensor in place
    ck.flush()
    step, st = ck.latest({"params": {"w": torch.zeros(6)},
                          "server_state": {},
                          "rng": np.zeros(2, np.uint32)})
    assert step == 1
    assert torch.equal(st["params"]["w"], torch.arange(6.0))
    np.testing.assert_array_equal(st["rng"], [1, 2])
    assert ck._pool is None   # the writer thread is gone after a flush
    assert flushes() == n0 + 1
    with pytest.raises(ValueError, match="holds"):
        ck.latest({"params": {"v": torch.zeros(6)}, "server_state": {},
                   "rng": np.zeros(2, np.uint32)})


def test_checkpoint_dir_expands_user(monkeypatch, tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path))
    args = TArguments(checkpoint_dir="~/ck", checkpoint_every_rounds=1)
    assert args.checkpoint_dir == str(tmp_path / "ck")
