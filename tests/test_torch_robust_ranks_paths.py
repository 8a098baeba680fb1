"""Robust mode over client ranks on the CPU, the other paths (see
``tests/test_torch_robust_ranks.py``): attacks, the quantized relayout,
the host path, a user aggregator and contribution at W = 2 against the
JAX engine on 2 virtual devices.

* each stochastic attack (byzantine_random, gaussian_noise, lazy_worker)
  draws on each feature shard with the rank's index folded into its key,
  as JAX folds the device's: the defended run agrees with JAX within the
  house tolerance ``rtol=2e-4, atol=2e-5``;
* the relayout as float32, bf16 and int8 rows (``robust_relayout_quant``,
  rounded before the all-to-all, the int8 scales all-gathered): f32 within
  the house tolerance, bf16 and int8 within ``tests/
  test_torch_aggregator.py``'s ``QUANT_TOL`` (a float32 tie flips a level,
  which moves the aggregate by a quantum times its weight); int8 moves a
  quarter of f32's all-to-all bytes and bf16 half;
* ``robust_fused: host`` on the sharded kernels (a block per round, the
  verdict read back), and a user ``ServerAggregator`` on the host path
  (every rank gathers every row and runs the hooks on the same ``[K,
  D]``), against JAX;
* LOO contribution (the coalition's mean taken on the feature shards and
  gathered, the eval batches split over the ranks, correct and count
  summed): the scores equal JAX's;
* every rank ends bitwise equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from fedml_tpu.core.algframe.server_aggregator import \
    ServerAggregator as JServerAggregator
from fedml_tpu_torch.interop import flax_to_state_dict

from torch_port_support import (ATOL, LR_BASE, RTOL, assert_history_close,
                                assert_ranks_bitwise, jax_init,
                                jax_on_devices, jax_params, rank_runs,
                                single_torch_thread)  # noqa: F401

pytestmark = pytest.mark.torch_port

W = 2
DEFENDED = dict(LR_BASE, comm_round=2, enable_defense=True,
                defense_type="coordinate_median", byzantine_client_num=1)
CASES = {
    **{a: dict(DEFENDED, enable_attack=True, attack_type=a)
       for a in ("byzantine_random", "gaussian_noise", "lazy_worker")},
    **{f"relayout_{q}": dict(LR_BASE, comm_round=2, enable_defense=True,
                             defense_type="multi_krum", krum_param_m=2,
                             robust_relayout_quant=q)
       for q in ("none", "bf16", "int8")},
    "host_krum": dict(DEFENDED, defense_type="krum", robust_fused="host",
                      enable_attack=True, attack_type="byzantine_flip"),
    "aggregator": dict(LR_BASE, comm_round=2, enable_attack=True,
                       attack_type="byzantine_flip", byzantine_client_num=1,
                       attack_scale=2.0),
    "loo": dict(LR_BASE, comm_round=2, contribution_method="LOO",
                frequency_of_the_test=1),
}
#: the quantized relayouts' bound (tests/test_torch_aggregator.py)
QUANT_TOL = {"relayout_int8": dict(rtol=2e-4, atol=1e-3),
             "relayout_bf16": dict(rtol=2e-4, atol=5e-4)}


class JMedianAggregator(JServerAggregator):
    """``torch_rank_programs.MedianAggregator`` in JAX."""

    def on_before_aggregation(self, update_matrix, weights):
        return update_matrix, jnp.maximum(weights, 1.0)

    def aggregate(self, update_matrix, weights):
        return jnp.median(update_matrix, axis=0)

    def on_after_aggregation(self, agg_vec):
        return agg_vec * 0.9


@pytest.fixture(scope="module")
def init():
    return flax_to_state_dict(jax_init(LR_BASE))


@pytest.fixture(scope="module")
def runs(init):
    return rank_runs("simulate_robust", W, mesh_shape={"client": W},
                     cases={n: (c, init, n == "aggregator")
                            for n, c in CASES.items()})


@pytest.fixture(scope="module")
def jax_runs():
    return {}


def jax_result(name, monkeypatch, jax_runs):
    if name not in jax_runs:
        kw = ({"server_aggregator": JMedianAggregator()}
              if name == "aggregator" else {})
        sim = jax_on_devices(CASES[name], W, monkeypatch, **kw)
        jax_runs[name] = (sim, sim.run())
    return jax_runs[name]


@pytest.mark.parametrize("name", sorted(CASES))
def test_path_over_ranks_matches_jax(runs, init, monkeypatch, jax_runs,
                                     name):
    got = runs[0][name]
    _, rj = jax_result(name, monkeypatch, jax_runs)
    want = jax_params(rj["params"])
    tol = QUANT_TOL.get(name, dict(rtol=RTOL, atol=ATOL))
    for k in want:
        np.testing.assert_allclose(got["params"][k], want[k], err_msg=k,
                                   **tol)
    assert_history_close(got["history"], rj["history"], **tol)
    assert max(float(np.abs(want[k] - init[k]).max()) for k in want) > 1e-3
    assert_ranks_bitwise(runs, name)


def test_quantized_relayout_moves_fewer_bytes(runs):
    st = {q: runs[0][f"relayout_{q}"]["stats"]
          for q in ("none", "bf16", "int8")}
    assert st["none"]["all_to_all_calls"] == 2
    assert st["int8"]["all_to_all_bytes"] * 4 == st["none"][
        "all_to_all_bytes"]
    assert st["bf16"]["all_to_all_bytes"] * 2 == st["none"][
        "all_to_all_bytes"]
    for s in st.values():
        assert s["all_to_all_wire_bytes"] * W == \
            s["all_to_all_bytes"] * (W - 1)
    # int8 adds the [S] scales' all-gather each round
    extra = st["int8"]["all_gather_calls"] - st["none"]["all_gather_calls"]
    assert extra == 2


def test_host_paths_gather_every_row(runs):
    d = sum(v.size for v in runs[0]["aggregator"]["params"].values())
    for r in runs:
        assert r["aggregator"]["aggregator_saw"] == [(4, d)] * 2
        assert r["aggregator"]["stats"]["all_to_all_calls"] == 0
        assert r["aggregator"]["stats"]["all_gather_calls"] == 4
        assert r["host_krum"]["stats"]["all_to_all_calls"] == 2
        assert sorted(r["host_krum"]["verdicts"]) == [0, 1]


def test_loo_scores_over_ranks_equal_jax(runs, monkeypatch, jax_runs):
    sim, _ = jax_result("loo", monkeypatch, jax_runs)
    want = sim.contribution.history
    for r in runs:
        got = r["loo"]["contribution"]
        assert [h["round"] for h in got] == [h["round"] for h in want]
        for g, j in zip(got, want):
            assert g["client_ids"] == list(j["client_ids"])
            np.testing.assert_allclose(g["contributions"],
                                       j["contributions"], atol=1e-6)
