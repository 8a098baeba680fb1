"""Buffered-async pours of the GPU engine over client ranks (the port's
``AsyncBufferedSimulator`` on ``mesh_shape={"client": 2}``) against the
JAX async engine on 2 virtual CPU devices, on the CPU.

Each rank trains the dispatched clients it holds (at most ``min(cpd,
concurrency)`` a dispatch, the JAX program's slot width; a client past it
waits for the next dispatch), one all-gather builds the replicated
dispatch matrix, and the buffer, the ring, the staleness weights and the
re-syncs stay replicated; a defended pour runs the feature-sharded
defense on this rank's column block of the re-based rows. From the same
flax parameters:

* a plain pour, a chaos-faulted one and a defended one (krum against a
  ``byzantine_flip`` client) agree with the JAX engine within the house
  tolerance ``rtol=2e-4, atol=2e-5`` (params and history);
* every dispatch draws the same cohort as the JAX engine's;
* every rank ends bitwise equal, with the same verdicts.
"""

from __future__ import annotations

import numpy as np
import pytest

from fedml_tpu_torch.interop import flax_to_state_dict

from torch_port_support import (ATOL, LR_BASE, RTOL, assert_history_close,
                                assert_ranks_bitwise, jax_init,
                                jax_on_devices, jax_params, rank_runs,
                                single_torch_thread)  # noqa: F401

pytestmark = pytest.mark.torch_port

W = 2
BASE = dict(LR_BASE, round_mode="async_buffered", client_num_per_round=6,
            async_buffer_k=3, comm_round=4)
CASES = {
    "plain": BASE,
    "chaos": dict(BASE, chaos_dropout_prob=0.2, chaos_straggler_prob=0.3,
                  chaos_straggler_work=0.5, chaos_seed=3),
    "defended": dict(BASE, enable_defense=True, defense_type="krum",
                     enable_attack=True, attack_type="byzantine_flip",
                     byzantine_client_num=1),
}


@pytest.fixture(scope="module")
def init():
    return flax_to_state_dict(jax_init(LR_BASE))


@pytest.fixture(scope="module")
def runs(init):
    return rank_runs("simulate_async", W, mesh_shape={"client": W},
                     cases={n: (c, init) for n, c in CASES.items()})


@pytest.mark.parametrize("name", sorted(CASES))
def test_async_pours_over_ranks_match_jax(runs, init, monkeypatch, name):
    sim = jax_on_devices(CASES[name], W, monkeypatch)
    cohorts, draw = [], sim._draw_cohort

    def record(target):
        cohorts.append(list(draw(target)))
        return cohorts[-1]

    sim._draw_cohort = record
    rj = sim.run()
    got = runs[0][name]
    want = jax_params(rj["params"])
    for k in want:
        np.testing.assert_allclose(got["params"][k], want[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert_history_close(got["history"], rj["history"])
    assert max(float(np.abs(want[k] - init[k]).max()) for k in want) > 1e-3
    assert got["cohorts"] == cohorts
    assert [h["round"] for h in got["history"]] == list(range(4))


def test_every_rank_ends_bitwise_equal(runs):
    for name in CASES:
        assert_ranks_bitwise(runs, name)
        for other in runs[1:]:
            assert other[name]["cohorts"] == runs[0][name]["cohorts"]
            assert sorted(other[name]["verdicts"]) == \
                sorted(runs[0][name]["verdicts"])
            for v, (ids, verdict) in runs[0][name]["verdicts"].items():
                assert other[name]["verdicts"][v][0] == ids
                np.testing.assert_array_equal(other[name]["verdicts"][v][1],
                                              verdict)
    assert sorted(runs[0]["defended"]["verdicts"]) == [0, 1, 2, 3]
    # one dispatch matrix all-gathered and one all-reduce per pour
    st = runs[0]["plain"]["stats"]
    assert st["ranks"] == W and st["allreduce_calls"] == 5
