"""The defended round of the GPU engine over client ranks (the port's
counterpart of ``TPUSimulator``'s fused robust round on ``mesh_shape=
{"client": W}``), on the CPU: the selection and statistics defenses.

The port runs W gloo rank processes (``core/launch.py::run_ranks``,
``tests/torch_rank_programs.py``); the JAX engine runs in this process
over W of the 8 virtual CPU devices. From the same flax parameters, with
a ``byzantine_flip`` attack on one client, each defense's rows are relaid
into feature shards by one ``all_to_all`` a round and defended by the
feature-sharded kernels of ``core/security/defense/sharded.py`` (Gram
products and row norms summed over the ranks). At W = 2:

* params and history agree with the JAX engine within the house tolerance
  ``rtol=2e-4, atol=2e-5``;
* every rank ends bitwise equal, with the same verdicts, and the verdicts
  equal the one-card engine's;
* the relayout's counted bytes: the payload of every all-to-all is this
  rank's ``[S, D_pad]`` float32 rows, its wire bytes ``(g - 1) / g`` of
  that, exactly (the JAX package's ring rule).

The other defenses, checkpoints and W = 4 are in
``tests/test_torch_robust_ranks_state.py``; attacks, relayouts, a user
aggregator, contribution and mesh axes beside ``client`` in
``tests/test_torch_robust_ranks_paths.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

from fedml_tpu_torch.interop import flax_to_state_dict

from torch_port_support import (ATOL, LR_BASE, RTOL, assert_history_close,
                                assert_ranks_bitwise, jax_init,
                                jax_on_devices, jax_params, port_sim,
                                rank_runs, single_torch_thread)  # noqa: F401

pytestmark = pytest.mark.torch_port

W = 2
ATTACK = dict(enable_attack=True, attack_type="byzantine_flip",
              byzantine_client_num=1)
DEFENSES = ("krum", "multi_krum", "bulyan", "rfa", "coordinate_median",
            "trimmed_mean", "three_sigma", "norm_clip", "outlier_detection",
            "residual_reweight")


#: bulyan over 4 rows keeps theta = 2 and averages beta = 1 of them per
#: coordinate, the one nearer their mean: a tie in every coordinate, broken
#: by the rows' last bits; over 7 rows (theta 5, beta 3) it has none
WIDER = {"bulyan": dict(client_num_per_round=7)}


def case(defense):
    return dict(LR_BASE, comm_round=2, enable_defense=True,
                defense_type=defense, krum_param_m=2, **ATTACK,
                **WIDER.get(defense, {}))


@pytest.fixture(scope="module")
def init():
    return flax_to_state_dict(jax_init(LR_BASE))


@pytest.fixture(scope="module")
def runs(init):
    """Every defense at W ranks, one spawn."""
    return rank_runs("simulate_robust", W, mesh_shape={"client": W},
                     cases={d: (case(d), init, False) for d in DEFENSES})


@pytest.mark.parametrize("defense", DEFENSES)
def test_defense_over_ranks_matches_jax(runs, init, monkeypatch, defense):
    got = runs[0][defense]
    rj = jax_on_devices(case(defense), W, monkeypatch).run()
    want = jax_params(rj["params"])
    for k in want:
        np.testing.assert_allclose(got["params"][k], want[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert_history_close(got["history"], rj["history"])
    assert max(float(np.abs(want[k] - init[k]).max()) for k in want) > 1e-3
    # the rows crossed the ranks: one all-to-all a round
    assert got["stats"]["all_to_all_calls"] == 2


def test_every_rank_ends_bitwise_equal_with_the_one_card_verdicts(runs,
                                                                   init):
    for d in DEFENSES:
        assert_ranks_bitwise(runs, d)
        verdicts = [r[d]["verdicts"] for r in runs]
        one = port_sim(case(d), init_params=init)
        one.run()
        assert sorted(verdicts[0]) == sorted(one.verdicts) == [0, 1], d
        for r, (ids, v) in one.verdicts.items():
            for other in verdicts:
                assert other[r][0] == list(ids), d
                np.testing.assert_array_equal(other[r][1], verdicts[0][r][1])
            np.testing.assert_array_equal(verdicts[0][r][1], np.asarray(v),
                                          err_msg=d)


def test_relayout_wire_bytes_follow_the_ring_rule(runs):
    """Each rank sends its ``[S, D_pad]`` float32 rows once a round;
    ``(g - 1) / g`` of them cross the wire; the all-gathers (weights and
    the defended shards) likewise."""
    d = sum(v.size for v in runs[0]["krum"]["params"].values())
    d_pad = d + (-d) % W
    for r in runs:
        for name in DEFENSES:
            st = r[name]["stats"]
            assert st["all_to_all_bytes"] % (d_pad * 4) == 0
            assert st["all_to_all_bytes"] >= 2 * 2 * d_pad * 4
            assert st["all_to_all_wire_bytes"] * W == \
                st["all_to_all_bytes"] * (W - 1)
            assert st["all_gather_wire_bytes"] * W == \
                st["all_gather_bytes"] * (W - 1)
            assert st["staged_bytes"] == 0      # gloo on the CPU
