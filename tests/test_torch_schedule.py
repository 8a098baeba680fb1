"""``core/schedule`` (a copy of the JAX package's): the cases of
``tests/test_schedule.py`` through the port — LPT balance, exact 2-worker
DP, runtime regression, schedules over a ``FaultPlan`` — and the port's
schedules equal the JAX package's on the same inputs."""

import numpy as np
import pytest

from fedml_tpu.core import schedule as jschedule
from fedml_tpu_torch.core.schedule import (RuntimeEstimator,
                                           SeqTrainScheduler,
                                           balanced_schedule)

pytestmark = pytest.mark.torch_port


def test_lpt_beats_round_robin():
    costs = [10, 1, 1, 1, 10, 1, 1, 1]
    sched, makespan = SeqTrainScheduler(costs, 2).schedule()
    assert makespan == 13  # optimal: {10,1,1,1} per worker
    rr = max(sum(costs[0::2]), sum(costs[1::2]))  # round-robin: 22 vs 4
    assert makespan < rr


def test_dp_two_workers_exact():
    costs = [3, 1, 4, 2, 2]
    sched, makespan = SeqTrainScheduler(costs, 2, mode="dp").schedule()
    assert makespan == 6  # perfect split of 12
    got = {frozenset(sched[0]), frozenset(sched[1])}
    all_items = sched[0] + sched[1]
    assert sorted(all_items) == [0, 1, 2, 3, 4]


def test_all_clients_assigned():
    sched, _ = SeqTrainScheduler([5, 4, 3, 2, 1], 3).schedule()
    assert sorted(i for dev in sched for i in dev) == [0, 1, 2, 3, 4]


def test_runtime_estimator_fits_linear():
    est = RuntimeEstimator()
    for n in [10, 20, 40, 80]:
        est.record(0, n, 0.5 * n + 2.0)
    assert abs(est.predict(0, 100) - 52.0) < 1e-6


def test_balanced_schedule_maps_ids():
    sampled = [7, 3, 9]
    costs = {3: 1.0, 7: 5.0, 9: 1.0}
    costs_arr = [costs.get(i, 0.0) for i in range(10)]
    out = balanced_schedule(sampled, costs_arr, 2)
    flat = sorted(i for dev in out for i in dev)
    assert flat == [3, 7, 9]
    loads = [sum(costs[i] for i in dev) for dev in out]
    assert max(loads) == 5.0  # the heavy client is alone


# --- partial-availability schedules from a FaultPlan (chaos subsystem) ------

def _survivors(plan, round_idx, sampled):
    faults = plan.round_faults(round_idx, sampled)
    return [c for c in sampled if c not in faults.dropped], faults


def test_schedule_over_faultplan_survivors():
    """Dropped clients leave the schedule entirely; every survivor is
    still assigned exactly once and the makespan only shrinks."""
    from fedml_tpu_torch.core.chaos import FaultPlan

    plan = FaultPlan(seed=21, dropout_prob=0.3)
    sampled = list(range(12))
    costs = [float(1 + (i % 4)) for i in range(12)]
    survivors, faults = _survivors(plan, 0, sampled)
    assert 0 < len(faults.dropped) < len(sampled)
    out = balanced_schedule(survivors, costs, 4)
    flat = sorted(i for dev in out for i in dev)
    assert flat == sorted(survivors)
    assert not any(c in flat for c in faults.dropped)
    _, full_makespan = SeqTrainScheduler(
        [costs[c] for c in sampled], 4).schedule()
    _, part_makespan = SeqTrainScheduler(
        [costs[c] for c in survivors], 4).schedule()
    assert part_makespan <= full_makespan


def test_schedule_under_faultplan_is_deterministic():
    """Same chaos seed -> same survivors -> same schedule, across plan
    instances (the property crash-resume scheduling leans on)."""
    from fedml_tpu_torch.core.chaos import FaultPlan

    costs = [float(1 + (i % 3)) for i in range(10)]
    outs = []
    for _ in range(2):
        plan = FaultPlan(seed=5, dropout_prob=0.25)
        per_round = []
        for r in range(6):
            survivors, _ = _survivors(plan, r, list(range(10)))
            per_round.append(balanced_schedule(survivors, costs, 3))
        outs.append(per_round)
    assert outs[0] == outs[1]


def test_straggler_costs_reweight_schedule():
    """A straggler running work_scale of its steps costs work_scale of its
    load — LPT must rebalance with the scaled costs."""
    from fedml_tpu_torch.core.chaos import FaultPlan

    plan = FaultPlan(seed=2, straggler_prob=0.5, straggler_work=0.5)
    sampled = list(range(8))
    faults = plan.round_faults(1, sampled)
    assert faults.work_scale  # some straggler fired
    base = [4.0] * 8
    scaled = [base[c] * faults.scale_for(c) for c in sampled]
    sched, makespan = SeqTrainScheduler(scaled, 2).schedule()
    assert sorted(i for dev in sched for i in dev) == sampled
    assert makespan < sum(base) / 2  # stragglers shrank the load


def test_dp_mode_on_survivors():
    """The exact 2-worker DP path also takes FaultPlan-filtered loads."""
    from fedml_tpu_torch.core.chaos import FaultPlan

    plan = FaultPlan(seed=3, dropout_prob=0.4)
    sampled = list(range(6))
    survivors, faults = _survivors(plan, 0, sampled)
    assert faults.dropped  # seed chosen so someone drops
    costs = [float(i + 1) for i in range(len(survivors))]
    sched, makespan = SeqTrainScheduler(costs, 2, mode="dp").schedule()
    assert sorted(i for dev in sched for i in dev) == list(
        range(len(survivors)))
    assert makespan >= sum(costs) / 2


def test_runtime_estimator_with_partial_rounds():
    """Observed round times from straggler rounds still fit the linear
    model — the estimator sees (scaled samples, scaled seconds) pairs."""
    est = RuntimeEstimator()
    for n, scale in [(10, 1.0), (20, 1.0), (40, 0.5), (80, 0.5)]:
        est.record(0, n * scale, (0.5 * n + 2.0) * scale)
    pred = est.predict(0, 50)
    assert 20.0 < pred < 35.0  # still ~linear despite mixed scales


@pytest.mark.parametrize("costs,workers,mode", [
    ([10, 1, 1, 1, 10, 1, 1, 1], 2, "lpt"), ([3, 1, 4, 2, 2], 2, "dp"),
    ([5.5, 4.25, 3, 2, 1, 9, 0.5], 3, "lpt")])
def test_schedules_equal_reference(costs, workers, mode):
    kw = {} if mode == "lpt" else {"mode": mode}
    assert SeqTrainScheduler(costs, workers, **kw).schedule() == \
        jschedule.SeqTrainScheduler(costs, workers, **kw).schedule()
    sampled = list(range(len(costs)))[::-1]
    assert balanced_schedule(sampled, costs, workers) == \
        jschedule.balanced_schedule(sampled, costs, workers)
