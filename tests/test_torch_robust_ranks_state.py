"""The defended round over client ranks on the CPU, continued (see
``tests/test_torch_robust_ranks.py``): the sign, clustering, pruning,
stochastic and stateful defenses at W = 2, two defenses at W = 4, and a
stateful defense's checkpoint over ranks.

* rlr, wbc, soteria (its per-row quantile gathers one row at a time),
  weak_dp and crfl (noise drawn per feature shard, the rank's index folded
  into the key as JAX folds the device's), foolsgold, cclip, slsgd and
  cross_round (their state laid out over the feature shards, as JAX's
  ``defense_state_spec`` lays it out) agree with the JAX engine on W
  devices within the house tolerance ``rtol=2e-4, atol=2e-5`` (foolsgold
  within ``rtol=1e-4, atol=1e-3``: its logit magnifies float32 rounding,
  as in ``tests/test_torch_robust.py``), every rank bitwise equal;
* rfa and foolsgold at W = 4 likewise;
* foolsgold run 3 rounds at W = 2 with a checkpoint every round and
  resumed after round 2 equals the uninterrupted run bitwise (the
  checkpoint holds every shard's columns; each rank takes its own back).
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from fedml_tpu_torch.interop import flax_to_state_dict

from torch_port_support import (ATOL, LR_BASE, RTOL, assert_history_close,
                                assert_ranks_bitwise, jax_init,
                                jax_on_devices, jax_params, rank_runs,
                                single_torch_thread)  # noqa: F401

pytestmark = pytest.mark.torch_port

ATTACK = dict(enable_attack=True, attack_type="byzantine_flip",
              byzantine_client_num=1)
DEFENSES = ("rlr", "wbc", "soteria", "weak_dp", "crfl", "foolsgold",
            "cclip", "slsgd", "cross_round")
WIDE = ("rfa", "foolsgold")
#: foolsgold's logit magnifies float32 rounding (tests/test_torch_robust.py)
TOL = {"foolsgold": dict(rtol=1e-4, atol=1e-3)}


#: rlr's sign vote over 4 rows, one flipped, ties at its threshold on an
#: entry whose sign the rows' last bits decide (the one-card engine and
#: JAX part there too); over 5 rows it has no tie
WIDER = {"rlr": dict(client_num_per_round=5)}


def case(defense):
    return dict(LR_BASE, comm_round=2, enable_defense=True,
                defense_type=defense, **ATTACK, **WIDER.get(defense, {}))


@pytest.fixture(scope="module")
def init():
    return flax_to_state_dict(jax_init(LR_BASE))


@pytest.fixture(scope="module")
def runs(init):
    """Every defense at W = 2 and the wide ones at W = 4, one spawn
    each."""
    return {w: rank_runs("simulate_robust", w, mesh_shape={"client": w},
                         cases={d: (case(d), init, False) for d in names})
            for w, names in ((2, DEFENSES), (4, WIDE))}


def _check(runs, init, monkeypatch, defense, w):
    got = runs[w][0][defense]
    rj = jax_on_devices(case(defense), w, monkeypatch).run()
    want = jax_params(rj["params"])
    tol = TOL.get(defense, dict(rtol=RTOL, atol=ATOL))
    for k in want:
        np.testing.assert_allclose(got["params"][k], want[k], err_msg=k,
                                   **tol)
    assert_history_close(got["history"], rj["history"], **tol)
    assert max(float(np.abs(want[k] - init[k]).max()) for k in want) > 1e-3
    assert got["stats"]["all_to_all_calls"] == 2
    assert_ranks_bitwise(runs[w], defense)


@pytest.mark.parametrize("defense", DEFENSES)
def test_defense_over_two_ranks_matches_jax(runs, init, monkeypatch,
                                            defense):
    _check(runs, init, monkeypatch, defense, 2)


@pytest.mark.parametrize("defense", WIDE)
def test_defense_over_four_ranks_matches_jax(runs, init, monkeypatch,
                                             defense):
    _check(runs, init, monkeypatch, defense, 4)


def test_stateful_defense_checkpoint_resumes_over_ranks(init, tmp_path):
    cfg = dict(case("foolsgold"), comm_round=3)
    out = rank_runs("simulate_resumed", 2, cfg=cfg, init=init,
                    mesh_shape={"client": 2}, ckpt_dir=str(tmp_path / "ck"),
                    split=2)
    for r in out:
        assert r["rounds"] == [2]
        for k, v in r["whole"].items():
            assert np.array_equal(v, r["resumed"][k]), k
    assert sorted(os.listdir(tmp_path / "ck"))[-1] == "round_00000002.fmtpu"
