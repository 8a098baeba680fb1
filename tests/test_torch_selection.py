"""Participant selection in the port (``core/selection``, the GPU engine's
and the SP loop's use of it) against the JAX package, on the CPU.

* the stats stores (dense and sparse), the four strategies, the streaming
  cohort assembler and the deadline pacer against the JAX package's
  copies, fed the same observations: identical selections and state
  dicts (exact: host numpy on both sides);
* the GPU engine at a block of 1 round against the JAX SP loop, and at a
  block of 2 against ``TPUSimulator`` (a block selects all its cohorts
  before it runs), from the same flax parameters, at the house tolerance
  ``rtol=2e-4, atol=2e-5``, with the same cohorts;
* reputation from the defense verdicts: the store's reputation and the
  benched clients equal the JAX engine's; reputation without
  ``chaos_tolerance`` raises; ``pin_adaptive`` under the fused robust
  path; the slot fold refused under a tracking strategy;
* the selection state rides the checkpoint (a resumed run equals the
  uninterrupted one bitwise) and crosses from a JAX store
  (``interop.selection_state_from_jax``): the port selects the JAX
  engine's next cohort;
* the queued device metrics come back in one read; selection records go
  to the obs sink.
"""

from __future__ import annotations

import logging

import numpy as np
import pytest
import torch

from fedml_tpu.arguments import Arguments as JArguments
from fedml_tpu.core import selection as jsel
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.core import selection as tsel
from fedml_tpu_torch.core.algframe.types import TrainHyper
from fedml_tpu_torch.interop import (flax_to_state_dict,
                                     selection_state_from_jax)

from torch_port_support import (LR_BASE, assert_params_close,  # noqa: F401
                                assert_params_equal, jax_init, jax_params,
                                jax_sim, port_sim, single_torch_thread)

pytestmark = pytest.mark.torch_port

N = 40


def _observe(store, seed=0, rounds=6):
    """A seeded history of every kind of observation."""
    rs = np.random.RandomState(seed)
    for r in range(rounds):
        ids = [int(c) for c in rs.choice(N, 10, replace=False)]
        store.record_selected(r, ids)
        for c in ids:
            w = float(rs.choice([0.0, 0.5, 1.0]))
            store.record_availability(c, participated=w > 0, work=w)
            if w > 0:
                store.record_loss(c, float(rs.exponential()))
                store.record_latency(c, float(rs.uniform(0.1, 3.0)))
                store.record_arrival(c, float(rs.uniform(0.5, 2.0)))
        store.record_verdict(ids[:6], rs.uniform(0, 1, 6).round(1))


def _assert_state_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def _assert_state_close(a, b):
    """Two runs' stores: counts and rounds exact, the trained losses at
    the house tolerance (two frameworks trained them)."""
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if np.issubdtype(x.dtype, np.floating):
            np.testing.assert_allclose(x, y, rtol=2e-4, atol=2e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_store_state_equals_jax(kind):
    cls = {"dense": "ClientStatsStore", "sparse": "SparseClientStatsStore"}
    ours = getattr(tsel, cls[kind])(N, loss_window=4, ema_alpha=0.3)
    theirs = getattr(jsel, cls[kind])(N, loss_window=4, ema_alpha=0.3)
    _observe(ours), _observe(theirs)
    _assert_state_equal(ours.state_dict(), theirs.state_dict())
    ids = list(range(0, N, 3))
    for q in ("reputation_for", "rms_loss_for", "last_loss_for",
              "latency_for", "ema_work_for"):
        np.testing.assert_array_equal(getattr(ours, q)(ids),
                                      getattr(theirs, q)(ids), err_msg=q)
    assert ours.population_dropout_mean() == \
        theirs.population_dropout_mean()


@pytest.mark.parametrize("strategy", list(tsel.SELECTION_STRATEGIES))
@pytest.mark.parametrize("pool", [0, 24], ids=["full", "pool"])
def test_strategy_selections_equal_jax(strategy, pool):
    knobs = dict(client_selection=strategy, random_seed=5,
                 client_num_in_total=N, selection_candidate_pool=pool,
                 sampling_stream="seeded")
    ours = tsel.SelectionManager(Arguments(**knobs), N)
    theirs = jsel.SelectionManager(JArguments(**knobs), N)
    _observe(ours.store, seed=1), _observe(theirs.store, seed=1)
    for r in range(6, 12):
        assert ours.select(r, 8) == theirs.select(r, 8), r


def test_uniform_default_is_the_sampling_schedule():
    from fedml_tpu_torch.simulation.sampling import client_sampling

    m = tsel.SelectionManager(Arguments(client_num_in_total=N), N)
    assert not m.track and not m.stateful
    for r in range(5):
        assert m.select(r, 7) == (client_sampling(r, N, 7), [])


def test_cohort_assembler_and_pacer_equal_jax():
    knobs = dict(random_seed=3, pacer_adapt_cohort=True,
                 pacer_util_window=2, pacer_deadline_s=10.0)
    a_ours = tsel.StreamingCohortAssembler(Arguments(**knobs),
                                           tsel.ClientStatsStore(N), N)
    a_theirs = jsel.StreamingCohortAssembler(JArguments(**knobs),
                                             jsel.ClientStatsStore(N), N)
    _observe(a_ours.store), _observe(a_theirs.store)
    chunks = lambda: tsel.population_chunks(N, chunk=7)  # noqa: E731
    elig = lambda ids: ids % 3 != 0                        # noqa: E731
    for r in range(3):
        ro = a_ours.assemble(r, 9, chunks(), eligible_fn=elig)
        rt = a_theirs.assemble(r, 9, chunks(), eligible_fn=elig)
        assert ro.cohort == rt.cohort
        assert (ro.scanned, ro.eligible) == (rt.scanned, rt.eligible)
    p_ours = tsel.DeadlinePacer.from_args(Arguments(**knobs))
    p_theirs = jsel.DeadlinePacer.from_args(JArguments(**knobs))
    for i, u in enumerate([5.0, 4.0, 4.1, 4.05, 4.0, 3.9, 3.9, 3.9]):
        for p in (p_ours, p_theirs):
            p.observe_utility(u)
            p.observe_round(completed=7 + i % 3, expected=9, wall_s=2.0 + i)
        assert p_ours.paced_cohort(8) == p_theirs.paced_cohort(8)
    _assert_state_equal(p_ours.state_dict(), p_theirs.state_dict())


def _cohorts(records):
    return [r["sampled"] for r in records if r.get("kind") == "selection"]


@pytest.fixture
def selection_records():
    from fedml_tpu_torch.core.obs import sink

    got = []
    sink.set_sink(got.append)
    yield got
    sink.set_sink(None)


@pytest.mark.parametrize("extra", [
    dict(client_selection="oort"), dict(client_selection="power_of_choice"),
    dict(client_selection="oort", selection_adaptive_oversample=True,
         chaos_dropout_prob=0.25, chaos_seed=2)],
    ids=["oort", "power_of_choice", "oort_adaptive_chaos"])
def test_engine_block_of_1_matches_jax_sp(extra, selection_records):
    cfg = dict(LR_BASE, comm_round=4, rounds_per_dispatch=1, **extra)
    p0 = flax_to_state_dict(jax_init(cfg))
    ts = port_sim(cfg, init_params=p0)
    rt = ts.run()
    if "chaos_dropout_prob" in extra:
        # the SP loop has no chaos: the JAX engine at a block of 1 is the
        # reference there
        rj = jax_sim(cfg).run()
    else:
        js = jax_sim(cfg, backend="sp")
        rj = js.run()
        _assert_state_close(ts.selection.state_dict(),
                            js.selection.state_dict())
    assert_params_close(rt["params"], jax_params(rj["params"]))
    assert len(_cohorts(selection_records)) == 4


@pytest.mark.parametrize("strategy", ["oort", "power_of_choice"])
def test_engine_block_of_2_matches_jax_engine(strategy):
    cfg = dict(LR_BASE, comm_round=5, rounds_per_dispatch=2,
               client_selection=strategy, frequency_of_the_test=4)
    p0 = flax_to_state_dict(jax_init(cfg))
    js, ts = jax_sim(cfg), port_sim(cfg, init_params=p0)
    rj, rt = js.run(), ts.run()
    assert_params_close(rt["params"], jax_params(rj["params"]))
    _assert_state_close(ts.selection.state_dict(), js.selection.state_dict())
    # blocks [0], [1, 2], [3, 4]: a block of 2 selects both cohorts first
    assert ts.dispatch_stats["dispatches"] == 3


REPUTATION = dict(client_num_per_round=8, client_selection="reputation",
                  enable_defense=True, defense_type="multi_krum",
                  krum_param_m=6, byzantine_client_num=2,
                  enable_attack=True, attack_type="byzantine_flip",
                  attack_scale=5.0, comm_round=6, random_seed=42,
                  learning_rate=0.1, frequency_of_the_test=100,
                  rounds_per_dispatch=1, max_total_samples=0)


def test_reputation_from_verdicts_matches_jax_engine():
    cfg = dict(LR_BASE, **REPUTATION)
    p0 = flax_to_state_dict(jax_init(cfg))
    js, ts = jax_sim(cfg), port_sim(cfg, init_params=p0)
    assert ts.robust_fused and js.robust_fused
    rj, rt = js.run(), ts.run()
    rep_t = ts.selection.store.reputation
    np.testing.assert_allclose(rep_t, js.selection.store.reputation,
                               rtol=1e-6, atol=1e-7)
    assert rep_t[0] < 0.3 and rep_t[1] < 0.3 and np.all(rep_t[2:] > 0.3)
    # the next schedule benches clients 0 and 1 as work-0 slots
    sampled, works = ts._schedule_for(6)
    benched = {c for c, w in zip(sampled, works) if w == 0.0}
    assert benched == {0, 1}
    assert_params_close(rt["params"], jax_params(rj["params"]))
    assert sorted(ts.verdicts) == list(range(6))


def test_reputation_requires_tolerance():
    with pytest.raises(ValueError, match="requires chaos_tolerance"):
        port_sim(dict(LR_BASE, client_selection="reputation",
                      chaos_tolerance=False))


def test_pin_adaptive_under_the_fused_robust_path(caplog):
    cfg = dict(LR_BASE, client_selection="oort",
               selection_adaptive_oversample=True, enable_defense=True,
               defense_type="coordinate_median", chaos_over_sample=0.5)
    with caplog.at_level(logging.WARNING):
        sim = port_sim(cfg)
    assert sim.robust_fused and not sim.selection.adaptive
    assert sim._sample_n == sim._static_n == 6
    assert "selection_adaptive_oversample disabled" in caplog.text
    host = port_sim(dict(cfg, robust_fused="host"))
    assert host.selection.adaptive and host._sample_n == 8


def test_slot_fold_refused_under_a_tracking_strategy():
    with pytest.raises(ValueError, match="consumes per-slot metrics"):
        port_sim(dict(LR_BASE, federated_optimizer="FedSGD",
                      client_slot_fold=True, client_selection="oort"))


def test_selection_state_checkpoint_resume_is_bitwise(tmp_path):
    cfg = dict(LR_BASE, comm_round=4, checkpoint_every_rounds=2,
               client_selection="oort")
    full = port_sim(dict(cfg, checkpoint_dir=str(tmp_path / "full")))
    rf = full.run()
    port_sim(dict(cfg, comm_round=2,
                  checkpoint_dir=str(tmp_path / "part"))).run()
    resumed = port_sim(dict(cfg, checkpoint_dir=str(tmp_path / "part")))
    rr = resumed.run()
    assert [h["round"] for h in rr["history"]] == [2, 3]
    assert_params_equal(rf["params"], rr["params"])
    _assert_state_equal(full.selection.state_dict(),
                        resumed.selection.state_dict())
    assert "selection" in full.ckpt_state()


def test_store_carried_across_from_jax_selects_the_same_cohort():
    cfg = dict(LR_BASE, comm_round=3, client_selection="oort",
               rounds_per_dispatch=1)
    js = jax_sim(cfg)
    js.run()
    ts = port_sim(cfg)
    ts.selection.load_state_dict(
        selection_state_from_jax(js.selection.state_dict()))
    _assert_state_equal(ts.selection.state_dict(), js.selection.state_dict())
    for r in (3, 4):
        assert ts._schedule_for(r)[0] == [int(c) for c in
                                          js._schedule_for(r)[0]]


def test_queued_device_metrics_come_back_in_one_read():
    m = tsel.SelectionManager(Arguments(client_selection="oort"), 6)
    loss = torch.tensor([[2.0, 0.0, 3.0]])
    count = torch.tensor([[4.0, 0.0, 2.0]])
    m.note_results(0, [1, 4, 5], tsel.slot_placement([1, 4, 5], 1, 6),
                   slot_metrics={"loss_sum": loss, "count": count},
                   verdict=torch.tensor([1.0, 0.0, 1.0]))
    m.note_results(1, [2], tsel.slot_placement([2], 1, 6),
                   slot_metrics={"loss_sum": torch.tensor([[1.0]]),
                                 "count": torch.tensor([[2.0]])},
                   verdict=np.asarray([0.5]))
    m.flush()
    last = m.store.last_loss_for([1, 4, 5, 2])
    np.testing.assert_array_equal(last[[0, 2, 3]], [0.5, 1.5, 0.5])
    # client 4 reported nothing (count 0): no loss recorded
    np.testing.assert_array_equal(
        last[1], tsel.ClientStatsStore(6).last_loss_for([4])[0])
    rep = m.store.reputation_for([1, 4, 5, 2])
    assert rep[1] < rep[0]
