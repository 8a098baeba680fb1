"""Chaos in the port (``core/chaos/plan.py``, the GPU engine's availability
faults and crash-at-round) against the JAX package, on the CPU.

* the plan's fault traces, work fractions and ledger records equal the JAX
  package's for several seeds (exact: both are numpy ``Generator`` streams
  seeded from the same tuples);
* the GPU engine under dropout and stragglers, ``chaos_tolerance`` on and
  off (FedLocalSGD too, whose client weight is 1 and not the sample
  count, so a dropped client's scheduled weight is the optimizer's),
  against ``TPUSimulator`` on the virtual CPU devices from the same flax
  parameters, at the house tolerance ``rtol=2e-4, atol=2e-5``, with the
  ledgers equal; static over-sampling the same way;
* chaos knobs at probability 0 (the plan built) give a run bitwise equal
  to a chaos-free one;
* a dropped client runs no step and writes no client state; a straggler
  runs ``ceil(epochs * real_batches * work)`` steps;
* ``chaos_crash_at_round`` raises ``ChaosCrash`` after the round's
  checkpoint is on disk, and the resumed run equals the uninterrupted one
  bitwise;
* ``backend="sp"`` refuses the engine's chaos knobs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import fedml_tpu_torch
from fedml_tpu.core.chaos import FaultPlan as JFaultPlan
from fedml_tpu_torch.core.algframe.local_training import step_count
from fedml_tpu_torch.core.algframe.types import TrainHyper
from fedml_tpu_torch.core.chaos import ChaosCrash, FaultLedger, FaultPlan
from fedml_tpu_torch.core.checkpoint import RoundCheckpointer
from fedml_tpu_torch.interop import flax_to_state_dict

from torch_port_support import (LR_BASE, assert_params_close,  # noqa: F401
                                assert_params_equal, jax_init, jax_params,
                                jax_sim, port_sim, single_torch_thread)

pytestmark = pytest.mark.torch_port

CHAOS = dict(chaos_dropout_prob=0.3, chaos_straggler_prob=0.3,
             chaos_straggler_work=0.5, chaos_seed=3)


@pytest.mark.parametrize("seed", [0, 3, 11, 2**31 + 5])
def test_fault_trace_equals_jax(seed):
    kw = dict(seed=seed, dropout_prob=0.25, straggler_prob=0.3,
              straggler_work=0.4)
    ours, theirs = FaultPlan(**kw), JFaultPlan(**kw)
    clients = list(range(0, 40, 3))
    for a, b in zip(ours.trace(6, clients), theirs.trace(6, clients)):
        assert a.dropped == b.dropped
        assert a.work_scale == b.work_scale
        assert [a.scale_for(c) for c in clients] == \
            [b.scale_for(c) for c in clients]
    assert ours.expected_work_fraction == theirs.expected_work_fraction
    for r in range(4):
        assert ours.crash_due(r) == theirs.crash_due(r)


def test_plan_from_args_and_link_decisions_equal_jax():
    from fedml_tpu.arguments import Arguments as JArguments
    from fedml_tpu_torch.arguments import Arguments

    knobs = dict(chaos_dropout_prob=0.2, chaos_straggler_prob=0.1,
                 chaos_crash_at_round=2, random_seed=5)
    ours = FaultPlan.from_args(Arguments(**knobs))
    theirs = JFaultPlan.from_args(JArguments(**knobs))
    assert repr(ours) == repr(theirs)
    assert ours.seed == 5 and ours.crash_at_round == 2
    link = dict(seed=9, link_loss_prob=0.3, link_dup_prob=0.3,
                link_delay_prob=0.5, link_delay_s=0.01)
    a, b = FaultPlan(**link), JFaultPlan(**link)
    for seq in range(20):
        da, db = a.link_decision(1, 2, seq), b.link_decision(1, 2, seq)
        assert (da.copies, da.delay_s) == (db.copies, db.delay_s)


def test_ledger_records_go_to_the_sink():
    from fedml_tpu_torch.core.obs import sink

    got = []
    sink.set_sink(got.append)
    try:
        led = FaultLedger()
        led.record_round(3, {"dropped": [1]}, {"participating": 2})
    finally:
        sink.set_sink(None)
    assert led.rounds() == [{"round_idx": 3, "injected": {"dropped": [1]},
                             "observed": {"participating": 2}}]
    assert got[0]["kind"] == "chaos" and got[0]["round_idx"] == 3
    assert got[0]["injected"] == {"dropped": [1]}


def _ledger(sim):
    return [(r["round_idx"], sorted(r["injected"]["dropped"]),
             r["injected"]["stragglers"], r["observed"])
            for r in sim.chaos_ledger.rounds()]


@pytest.mark.parametrize("extra", [
    dict(CHAOS), dict(CHAOS, chaos_tolerance=False),
    dict(CHAOS, chaos_over_sample=0.5),
    dict(CHAOS, rounds_per_dispatch=1, comm_round=4),
    dict(CHAOS, chaos_tolerance=False, federated_optimizer="FedLocalSGD")],
    ids=["tolerance_on", "tolerance_off", "over_sample", "blocks_of_1",
         "localsgd_tolerance_off"])
def test_engine_under_chaos_matches_jax_engine(extra):
    cfg = dict(LR_BASE, **extra)
    p0 = flax_to_state_dict(jax_init(cfg))
    js, ts = jax_sim(cfg), port_sim(cfg, init_params=p0)
    rj, rt = js.run(), ts.run()
    assert_params_close(rt["params"], jax_params(rj["params"]))
    for hj, ht in zip(rj["history"], rt["history"]):
        np.testing.assert_allclose(ht["train_loss"], hj["train_loss"],
                                   rtol=2e-4, atol=2e-5)
    assert _ledger(ts) == _ledger(js)
    assert len(_ledger(ts)) == cfg["comm_round"]
    if "chaos_over_sample" in extra:
        assert all(o["sampled"] == 6 for *_, o in _ledger(ts))


def test_zero_probabilities_are_bitwise_chaos_free():
    cfg = dict(LR_BASE, comm_round=2)
    plain = fedml_tpu_torch.run_simulation(device="cpu", **cfg)
    zero = fedml_tpu_torch.run_simulation(
        device="cpu", chaos_dropout_prob=0.0, chaos_straggler_prob=0.0,
        chaos_over_sample=0.0, chaos_tolerance=False, chaos_seed=4, **cfg)
    assert_params_equal(plain["params"], zero["params"])
    assert [h["train_loss"] for h in plain["history"]] == \
        [h["train_loss"] for h in zero["history"]]


def test_dropped_clients_run_no_step_and_keep_their_state():
    """SCAFFOLD keeps a per-client control variate: a dropped client's row
    is the same before and after the round; stragglers run their share of
    the steps; the round's step total is the plan's."""
    cfg = dict(LR_BASE, federated_optimizer="SCAFFOLD", **CHAOS)
    sim = port_sim(cfg)
    hyper = TrainHyper(learning_rate=0.1, epochs=1)
    before = {k: v.clone() for k, v in sim.client_states["c_i"].items()}
    out = sim.run_round(0, hyper)
    rec = sim.chaos_ledger.rounds()[0]
    dropped = rec["injected"]["dropped"]
    stragglers = {int(c): w for c, w in rec["injected"]["stragglers"].items()}
    assert dropped, "the seed drops no client in round 0"
    sampled = sim.selection.strategy.select(0, 4)[0]
    want = sum(step_count(sim.batch_real[c], TrainHyper(
        0.1, 1, stragglers.get(c, 1.0))) for c in sampled
        if c not in dropped)
    assert out["local_steps"] == want
    after = sim.client_states["c_i"]
    for k in before:
        for c in dropped:
            assert torch.equal(before[k][c], after[k][c]), (k, c)
        trained = [c for c in sampled if c not in dropped]
        assert any(not torch.equal(before[k][c], after[k][c])
                   for c in trained), k


def test_crash_at_round_then_resume_is_bitwise(tmp_path):
    cfg = dict(LR_BASE, comm_round=3, checkpoint_every_rounds=1, **CHAOS)
    full = fedml_tpu_torch.run_simulation(
        device="cpu", checkpoint_dir=str(tmp_path / "full"), **cfg)
    crash_dir = str(tmp_path / "crash")
    with pytest.raises(ChaosCrash) as ei:
        fedml_tpu_torch.run_simulation(device="cpu", checkpoint_dir=crash_dir,
                                       chaos_crash_at_round=1, **cfg)
    assert ei.value.round_idx == 1
    # round 1's checkpoint was flushed before the raise
    assert RoundCheckpointer(crash_dir, 1).steps()[-1] == 1
    resumed = fedml_tpu_torch.run_simulation(
        device="cpu", checkpoint_dir=crash_dir, chaos_crash_at_round=1,
        **cfg)
    assert [h["round"] for h in resumed["history"]] == [2]
    assert_params_equal(full["params"], resumed["params"])


@pytest.mark.parametrize("knob,value", [
    ("chaos_dropout_prob", 0.2), ("chaos_straggler_prob", 0.1),
    ("chaos_crash_at_round", 1), ("chaos_over_sample", 0.5)])
def test_sp_backend_refuses_engine_chaos(knob, value):
    with pytest.raises(NotImplementedError, match="SP golden loop injects "
                       "no chaos") as ei:
        fedml_tpu_torch.run_simulation(backend="sp", device="cpu",
                                       **dict(LR_BASE, **{knob: value}))
    assert knob in str(ei.value)
