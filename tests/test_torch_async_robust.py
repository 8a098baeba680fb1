"""Defended buffered-async pours in the port (the base-delta ring, the
in-pour model attack, the one-card defense kernels with partial-pour row
masks) against the JAX package, on the CPU.

* a staleness-0 defended pour (K = concurrency, constant weighting, alpha
  1: merge scale exactly 1.0) is bitwise the port's sync sharded defense
  on the same rows, weights, ids and key, added to the params;
* every masked kernel family equals JAX's masked kernel (a one-device
  mesh) on a partial pour — the median, trimmed mean, krum never
  selecting padding and three_sigma also against their plain meaning on
  the valid rows; ``row_mask=None`` is the unmasked kernel;
* the defended engine against ``fedml_tpu``'s, pour by pour (params at
  the house tolerance, ledger and verdicts): krum under byzantine_random
  (the JAX engine on a one-device mesh, whose attack stream draws the
  shard-0 key the port's one card draws) and foolsgold (stateful) with
  partial pours under heavy dropout;
* every ``DEFENSE_TYPES`` entry composes with a pour or refuses as
  documented; reputation benches the byzantine clients out of the
  rotation; oort and power_of_choice rank the idle pool as the reference
  does; a defended crash-resume (ring and defense state in the
  checkpoint) is bitwise.
"""

from __future__ import annotations

from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu_torch.core.security.defense import sharded as tsharded
from fedml_tpu_torch.interop import flax_to_state_dict

from torch_port_support import (LR_BASE, assert_params_close,  # noqa: F401
                                assert_params_equal, jax_init, jax_params,
                                port_sim, single_torch_thread)

pytestmark = pytest.mark.torch_port

ASYNC = dict(LR_BASE, client_num_per_round=8, comm_round=4,
             round_mode="async_buffered", async_buffer_k=4)
BYZ = dict(enable_attack=True, attack_type="byzantine_random",
           attack_scale=10.0, byzantine_client_num=2)


def one_device_mesh():
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:1]), ("client",))


def jax_async(cfg, mesh=None):
    """``fedml_tpu``'s AsyncBufferedSimulator for ``cfg`` (on ``mesh``,
    the 8 virtual CPU devices by default)."""
    import fedml_tpu
    import fedml_tpu.data as jdata
    import fedml_tpu.model as jmodel
    from fedml_tpu.core.algframe.client_trainer import make_trainer_spec
    from fedml_tpu.optimizers.registry import create_optimizer
    from fedml_tpu.simulation.tpu.async_engine import AsyncBufferedSimulator

    args = fedml_tpu.init(None, backend="tpu", **cfg)
    fed, out_dim = jdata.load(args)
    bundle = jmodel.create(args, out_dim)
    spec = make_trainer_spec(fed, bundle)
    return AsyncBufferedSimulator(args, fed, bundle,
                                  create_optimizer(args, spec), spec,
                                  mesh=mesh)


def hypers(cfg):
    from fedml_tpu.core.algframe.types import TrainHyper as JHyper
    from fedml_tpu_torch.core.algframe.types import TrainHyper
    return (JHyper(learning_rate=jnp.float32(cfg["learning_rate"]),
                   epochs=1),
            TrainHyper(learning_rate=cfg["learning_rate"], epochs=1))


def pours(sim):
    return [(p["round_idx"], p["injected"], p["observed"])
            for p in sim.chaos_ledger.pours()]


# --- the parity anchor: staleness 0 == the sync defense ----------------------

@pytest.mark.parametrize("defense,extra", [
    ("krum", dict(byzantine_client_num=1)),
    ("median", {}),
    ("foolsgold", {})])
def test_staleness0_pour_is_bitwise_the_sync_defense(defense, extra):
    from fedml_tpu_torch import prng
    from fedml_tpu_torch.core.async_rounds import pour_weights
    from fedml_tpu_torch.simulation.gpu.engine import DEFENSE_FOLD

    cfg = dict(ASYNC, async_buffer_k=8, async_alpha=1.0,
               async_staleness_weighting="constant", enable_defense=True,
               defense_type=defense, **extra)
    sim = port_sim(cfg)
    hyper = hypers(cfg)[1]
    sim._bootstrap(hyper)
    sim._absorb_until(sim.k)
    entries = list(sim.buffer._entries)
    assert len(entries) == sim.k and all(e.version == 0 for e in entries)
    mat = torch.stack([e.update for e in entries])
    norm_w, merge_scale = pour_weights([e.weight for e in entries],
                                       np.zeros(len(entries)),
                                       sim._staleness_fn(), sim.merge_alpha)
    assert merge_scale == 1.0
    before = {k: v.clone() for k, v in sim.params.items()}
    state = (None if sim._defense_state is None else
             {k: v.clone() for k, v in sim._defense_state.items()})
    sim._pour_step(hyper)
    key = prng.fold_in(prng.fold_in(sim.rng, sim._dispatch_seq),
                       DEFENSE_FOLD)
    out = tsharded.defend_matrix_sharded(
        mat, torch.tensor(norm_w), defense,
        hp=tsharded.DefenseHP.from_defender(sim.defender), state=state,
        ids=torch.tensor([e.client_id for e in entries]), defense_key=key,
        row_mask=torch.ones(len(entries)))
    vec = out[0] if isinstance(out, tuple) else out
    want = {k: before[k] + v for k, v in sim.layout.unflatten(vec).items()}
    assert_params_equal(want, sim.params)
    # the ring's slot 0 holds the pour's movement
    np.testing.assert_array_equal(
        sim._ring[0].numpy(),
        (sim.layout.flatten(sim.params) - sim.layout.flatten(before)).numpy())


# --- partial-pour row masks ---------------------------------------------------

def _partial_pour(seed=0, k=8, valid=5, d=24):
    rng = np.random.default_rng(seed)
    mat = rng.normal(size=(k, d)).astype(np.float32)
    mat[1] *= 6.0                                 # an outlier
    mat[valid:] = 0.0                             # padding
    mask = np.asarray([1.0] * valid + [0.0] * (k - valid), np.float32)
    w = rng.uniform(1, 2, k).astype(np.float32) * mask
    ids = np.asarray([3, 1, 0, 5, 7, 2, 4, 6][:k], np.int64)
    return mat, mask, w, ids


MASKED = ["median", "trimmed_mean", "krum", "multi_krum", "bulyan",
          "three_sigma", "outlier_detection", "residual_reweight", "wbc",
          "slsgd", "foolsgold", "cross_round", "mean", "rfa", "norm_clip",
          "rlr", "cclip", "soteria"]


@pytest.mark.parametrize("defense", MASKED)
def test_masked_kernel_matches_jax(defense):
    from fedml_tpu.core.security.defense import sharded as jsharded
    mat, mask, w, ids = _partial_pour()
    hp = dict(byzantine_count=1, multi_k=2, trim_fraction=0.2)
    stateful = tsharded.is_stateful(defense)
    state_j, state_t = None, None
    for rnd in range(2):            # stateful kernels: history carried
        m = mat * (1.0 + 0.5 * rnd)
        out_j = jsharded.defend_matrix_sharded(
            one_device_mesh(), "client", jnp.asarray(m), jnp.asarray(w),
            defense, hp=jsharded.DefenseHP(**hp), ids=ids.astype(np.int32),
            state=state_j, row_mask=mask, return_verdict=True)
        out_t = tsharded.defend_matrix_sharded(
            torch.tensor(m), torch.tensor(w), defense,
            hp=tsharded.DefenseHP(**hp), ids=torch.tensor(ids),
            state=state_t, row_mask=torch.tensor(mask), return_verdict=True)
        np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out_t[-1].numpy(), np.asarray(out_j[-1]),
                                   rtol=1e-5, atol=1e-6)
        if stateful:
            state_j, state_t = out_j[1], out_t[1]
            for k in state_j:
                np.testing.assert_allclose(state_t[k].numpy(),
                                           np.asarray(state_j[k]),
                                           rtol=1e-5, atol=1e-6)
        if defense in ("krum", "multi_krum", "three_sigma",
                       "outlier_detection", "wbc", "cross_round"):
            # a verdict never keeps padding (bulyan's theta = K - 2f may
            # exceed the valid rows: it then takes padding, as in JAX)
            assert float(out_t[-1][mask == 0].abs().sum()) == 0.0


def test_masked_kernels_mean_the_valid_rows():
    mat, mask, w, ids = _partial_pour(seed=2, valid=4)
    valid = mat[:4]

    def run(defense, m=mat, **hp):
        return tsharded.defend_matrix_sharded(
            torch.tensor(m), torch.tensor(w), defense,
            hp=tsharded.DefenseHP(**hp), row_mask=torch.tensor(mask)).numpy()

    np.testing.assert_allclose(run("median"), np.median(valid, axis=0),
                               rtol=1e-6, atol=1e-7)
    s = np.sort(valid, axis=0)
    np.testing.assert_allclose(run("trimmed_mean", trim_fraction=0.25),
                               np.mean(s[1:3], axis=0), rtol=1e-5, atol=1e-6)
    two = np.zeros((4, 8), np.float32)
    two[0], two[1] = 1.0, 1.01         # rows 2, 3: padding, closest pair
    got = tsharded.defend_matrix_sharded(
        torch.tensor(two), torch.ones(4), "krum",
        row_mask=torch.tensor([1.0, 1.0, 0.0, 0.0])).numpy()
    assert abs(float(np.mean(got)) - 1.0) < 0.1       # a real row won
    tight = np.zeros_like(mat)
    tight[:4] = 1.0 + 0.01 * np.random.default_rng(3).normal(size=(4, 24))
    np.testing.assert_allclose(run("three_sigma", m=tight),
                               np.average(tight[:4], axis=0, weights=w[:4]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("defense", ["median", "trimmed_mean", "krum",
                                     "three_sigma", "wbc", "bulyan",
                                     "residual_reweight"])
def test_row_mask_none_is_the_unmasked_kernel(defense):
    """The sync paths never pass a mask: ``row_mask=None`` runs the
    unmasked kernel (equal to JAX's unmasked one), and an all-ones mask
    gives the same aggregate."""
    from fedml_tpu.core.security.defense import sharded as jsharded
    rng = np.random.default_rng(3)
    mat = rng.normal(size=(6, 16)).astype(np.float32)
    w = rng.uniform(1, 2, 6).astype(np.float32)
    hp = dict(byzantine_count=1)
    plain = tsharded.defend_matrix_sharded(
        torch.tensor(mat), torch.tensor(w), defense,
        hp=tsharded.DefenseHP(**hp)).numpy()
    ones = tsharded.defend_matrix_sharded(
        torch.tensor(mat), torch.tensor(w), defense,
        hp=tsharded.DefenseHP(**hp), row_mask=torch.ones(6)).numpy()
    jplain = np.asarray(jsharded.defend_matrix_sharded(
        one_device_mesh(), "client", jnp.asarray(mat), jnp.asarray(w),
        defense, hp=jsharded.DefenseHP(**hp)))
    np.testing.assert_allclose(plain, jplain, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(plain, ones, rtol=1e-6, atol=1e-7)
    # the unmasked path is the host kernel's arithmetic where they share
    # it (the coordinate median: bit for bit)
    if defense == "median":
        from fedml_tpu_torch.core.security.defense import robust_agg
        assert torch.equal(torch.tensor(plain),
                           robust_agg.median0(torch.tensor(mat)))


# --- the defended engine against the JAX engine -------------------------------

@pytest.mark.parametrize("extra,one_device", [
    (dict(BYZ, enable_defense=True, defense_type="krum"), True),
    (dict(enable_defense=True, defense_type="foolsgold",
          client_num_per_round=4, async_buffer_k=4,
          chaos_dropout_prob=0.5, chaos_seed=5, comm_round=5), False),
    (dict(BYZ, attack_type="byzantine_flip", enable_defense=True,
          defense_type="median", async_staleness_weighting="hinge",
          async_hinge_b=0), False)],
    ids=["krum_byzantine_random", "foolsgold_partial_pours",
         "median_flip_hinge"])
def test_defended_engine_matches_jax(extra, one_device):
    cfg = dict(ASYNC, **extra)
    p0 = flax_to_state_dict(jax_init(cfg))
    js = jax_async(cfg, mesh=one_device_mesh() if one_device else None)
    ts = port_sim(cfg, init_params=p0)
    hj, ht = hypers(cfg)
    js._bootstrap(hj)
    ts._bootstrap(ht)
    partial = 0
    for _ in range(cfg["comm_round"]):
        a, b = js._pour_step(hj), ts._pour_step(ht)
        assert (a["poured"], a["staleness_mean"]) == \
            (b["poured"], b["staleness_mean"])
        partial += 0 < b["poured"] < ts.k
        assert_params_close(ts.params, jax_params(js.params))
    assert pours(ts) == pours(js)
    np.testing.assert_allclose(ts._ring.numpy(),
                               np.asarray(jax.device_get(js._ring)),
                               rtol=2e-4, atol=2e-5)
    if "chaos_dropout_prob" in extra:
        assert partial >= 1              # a partial pour was masked
        # (JAX's history is padded to a multiple of its 8 devices)
        np.testing.assert_allclose(
            ts._defense_state["history"].numpy(),
            np.asarray(jax.device_get(js._defense_state["history"]))[
                :, :ts._true_d], rtol=2e-4, atol=2e-5)
    for v, (ids, verdict) in ts.verdicts.items():
        assert len(ids) == verdict.shape[0]


@pytest.mark.parametrize("defense", __import__(
    "fedml_tpu_torch.core.security", fromlist=["DEFENSE_TYPES"]).DEFENSE_TYPES)
def test_every_defense_composes_or_refuses(defense):
    cfg = dict(ASYNC, client_num_in_total=4, client_num_per_round=4,
               async_buffer_k=2, comm_round=2, enable_defense=True,
               defense_type=defense, byzantine_client_num=1)
    if defense in ("weak_dp", "crfl"):
        with pytest.raises(ValueError, match="noise-adding"):
            port_sim(cfg)
        return
    sim = port_sim(cfg)
    r = sim.run()
    assert r["rounds"] == 2
    for v in sim.params.values():
        assert torch.isfinite(v).all(), defense


def test_reputation_benches_byzantine_out_of_rotation():
    cfg = dict(ASYNC, comm_round=40, enable_defense=True,
               defense_type="multi_krum", krum_param_m=2,
               byzantine_client_num=2, enable_attack=True,
               attack_type="byzantine_random", attack_scale=10.0,
               client_selection="reputation", random_seed=3)
    sim = port_sim(cfg)
    r = sim.run()
    rep = sim.selection.store.reputation
    assert rep[0] < 0.3 and rep[1] < 0.3, rep
    late = {a["client"] for p in sim.chaos_ledger.pours()[-6:]
            for a in p["injected"]["arrivals"]}
    assert late and not (late & {0, 1}), sorted(late)
    assert np.isfinite(r["final_test_acc"])


@pytest.mark.parametrize("strategy", ["oort", "power_of_choice"])
def test_idle_pool_ranking_equals_reference(strategy):
    cfg = dict(ASYNC, client_selection=strategy)
    js, ts = jax_async(cfg), port_sim(cfg)
    for sim in (js, ts):
        for c in range(8):
            sim.selection.store.record_loss(c, float((5 * c) % 8) + 0.5)
            if c % 3:
                sim.selection.store.record_arrival(c, 1.0 + 0.1 * c)
        sim._idle = deque(range(8))
        sim._rank_idle()
    assert list(ts._idle) == list(js._idle)
    assert ts.selection.track
    # and a run ranks the same pools as the JAX engine
    cfg = dict(cfg, client_num_per_round=4, async_buffer_k=2, comm_round=5)
    p0 = flax_to_state_dict(jax_init(cfg))
    js, ts = jax_async(cfg), port_sim(cfg, init_params=p0)
    hj, ht = hypers(cfg)
    js._bootstrap(hj)
    ts._bootstrap(ht)
    for _ in range(cfg["comm_round"]):
        js._pour_step(hj)
        ts._pour_step(ht)
        assert list(ts._idle) == list(js._idle)
    assert pours(ts) == pours(js)


def test_defended_crash_resume_is_bitwise(tmp_path):
    from fedml_tpu_torch.core.chaos import ChaosCrash
    cfg = dict(ASYNC, comm_round=6, enable_defense=True,
               defense_type="foolsgold", chaos_straggler_prob=0.3,
               chaos_straggler_work=0.5, chaos_seed=13)
    full = port_sim(cfg)
    r_full = full.run()
    ck = dict(cfg, checkpoint_dir=str(tmp_path / "ck"),
              checkpoint_every_rounds=2, chaos_crash_at_round=3)
    with pytest.raises(ChaosCrash):
        port_sim(ck).run()
    resumed = port_sim(dict(ck, chaos_crash_at_round=None))
    r_res = resumed.run()
    assert [h["round"] for h in r_res["history"]] == [4, 5]
    assert_params_equal(r_full["params"], r_res["params"])
    assert torch.equal(full._ring, resumed._ring)
    assert torch.equal(full._defense_state["history"],
                       resumed._defense_state["history"])
