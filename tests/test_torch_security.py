"""Attacks and defenses of the port against the JAX package's
(``fedml_tpu/core/security/``, ``fedml_tpu/simulation/poisoning.py``), on
the CPU, at the same keys and inputs.

* every model attack on a ``[K, D]`` matrix: bit for bit (its noise is
  ``prng.normal_t``);
* the data attacks on the clients' host arrays: exactly;
* each of the 22 ``DEFENSE_TYPES`` through ``FedMLDefender`` (the host
  kernels), and through the port's one-card ``sharded`` kernels against
  JAX's ``defend_matrix_sharded`` on a one-device CPU mesh, over 3 rounds
  so the stateful defenses carry their state: aggregate and verdict
  within ``rtol=2e-5, atol=2e-6`` (float32 reductions associate
  differently in XLA and torch; FoolsGold's logit rescale magnifies them,
  so its weights and the aggregate they make are held to ``rtol=1e-4,
  atol=1e-5``), selections and keep flags exactly.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from fedml_tpu.core.security import attack as jattack
from fedml_tpu.core.security import defense as jdefense
from fedml_tpu.core.security.defense import sharded as jsharded
from fedml_tpu_torch import prng
from fedml_tpu_torch.core.security import attack as tattack
from fedml_tpu_torch.core.security import defense as tdefense
from fedml_tpu_torch.core.security.defense import robust_agg
from fedml_tpu_torch.core.security.defense import sharded as tsharded

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-5, 2e-6
FG_TOL = dict(rtol=1e-4, atol=1e-5)
K, D = 8, 37
MODEL_ATTACKS = ("byzantine_random", "byzantine_zero", "byzantine_flip",
                 "model_replacement", "gaussian_noise", "lazy_worker")
STATEFUL = ("foolsgold", "cclip", "slsgd", "cross_round")


def _matrix(seed, k=K, d=D):
    """Honest rows around a common direction, two outlier rows."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=d).astype(np.float32)
    mat = (base + 0.3 * rng.normal(size=(k, d))).astype(np.float32)
    mat[:2] = (-4.0 * base + rng.normal(size=(2, d))).astype(np.float32)
    w = rng.uniform(5, 20, size=k).astype(np.float32)
    return mat, w


def _args(defense_type, **kw):
    base = dict(enable_defense=True, defense_type=defense_type,
                enable_attack=False, attack_type=None,
                byzantine_client_num=2, krum_param_m=3,
                client_num_in_total=12, beta=0.2, norm_bound=2.0, tau=3.0,
                stddev=0.01, alpha=0.5, rfa_iters=6, rfa_tol=0.0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _close(t, j, **kw):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                               rtol=kw.get("rtol", RTOL),
                               atol=kw.get("atol", ATOL))


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("client",))


@pytest.mark.parametrize("attack", MODEL_ATTACKS)
def test_model_attack_bit_equal(attack):
    mat, _ = _matrix(1)
    ids = np.array([0, 5, 1, 7, 2, 3, 9, 4])
    cfg = dict(enable_attack=True, attack_type=attack,
               byzantine_client_num=3, attack_scale=2.5)
    key = prng.fold_in(prng.PRNGKey(3), 1000003)
    out_t = tattack.FedMLAttacker(types.SimpleNamespace(**cfg)) \
        .poison_updates(torch.from_numpy(mat), ids, key)
    out_j = jattack.FedMLAttacker(types.SimpleNamespace(**cfg)) \
        .poison_updates(jnp.asarray(mat), ids, jnp.asarray(key))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    # the one-card sharded injection folds the shard index 0 in, as JAX
    # does on a one-device mesh
    mask = tattack.FedMLAttacker(types.SimpleNamespace(**cfg)) \
        .byzantine_mask(ids)
    out_s = tsharded.apply_attack(attack, torch.from_numpy(mat),
                                  torch.from_numpy(mask), key, 2.5)
    ref = jattack.FedMLAttacker(types.SimpleNamespace(**cfg)).poison_updates(
        jnp.asarray(mat), ids, jax.random.fold_in(jnp.asarray(key), 0))
    np.testing.assert_array_equal(out_s.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def mnist_feds():
    import fedml_tpu.data as jdata
    from fedml_tpu.arguments import Arguments as JArguments
    from fedml_tpu_torch import data as tdata
    from fedml_tpu_torch.arguments import Arguments
    out = {}
    for name, cfg in (("flat", dict(dataset="synthetic_mnist", model="lr")),
                      ("image", dict(dataset="synthetic_mnist",
                                     model="resnet20"))):
        cfg = dict(cfg, client_num_in_total=5, batch_size=8, random_seed=1,
                   max_total_samples=120, synthetic_test_size=24)
        out[name] = (jdata.load(JArguments(**cfg))[0],
                     tdata.load(Arguments(**cfg))[0])
    return out


@pytest.mark.parametrize("attack", ["label_flip", "backdoor",
                                    "edge_case_backdoor"])
@pytest.mark.parametrize("layout", ["flat", "image"])
def test_data_poisoning_equal(mnist_feds, attack, layout):
    from fedml_tpu.simulation.poisoning import poison_dataset as jpoison
    from fedml_tpu_torch.simulation.poisoning import poison_dataset
    fj, ft = mnist_feds[layout]
    cfg = types.SimpleNamespace(enable_attack=True, attack_type=attack,
                                byzantine_client_num=2,
                                backdoor_target_label=3)
    pj = jpoison(fj, jattack.FedMLAttacker(cfg))
    pt = poison_dataset(ft, tattack.FedMLAttacker(cfg))
    for f in ("x", "y", "mask"):
        np.testing.assert_array_equal(np.asarray(getattr(pt.train, f)),
                                      np.asarray(getattr(pj.train, f)))
    assert not np.array_equal(np.asarray(pt.train.y if attack ==
                                         "label_flip" else pt.train.x),
                              np.asarray(ft.train.y if attack ==
                                         "label_flip" else ft.train.x))


@pytest.mark.parametrize("info,want", [
    ({"selected": np.array([1., 0., 1.])}, [1., 0., 1.]),
    ({"selected": np.array([2, 0, 1])}, None),          # bulyan's indices
    ({"kept": np.float32(2.0)}, None),                  # wbc's count
    ({"fg_weights": np.array([0.5, 1.0, 0.0])}, [0.5, 1.0, 0.0]),
    ({"confidence": np.array([1.5, 0., 0.])}, None),
    ({}, None), (None, None)])
def test_verdict_from_info(info, want):
    as_t = None if info is None else {
        k: torch.as_tensor(v) for k, v in info.items()}
    for i in (info, as_t):
        got_t = tdefense.verdict_from_info(i, 3)
        got_j = jdefense.verdict_from_info(i if i is info else info, 3)
        for got in (got_t, got_j):
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, np.float32(want))


def _verdict_t(info, k):
    return tdefense.verdict_from_info(info, k)


@pytest.mark.parametrize("defense", tdefense.DEFENSE_TYPES)
def test_host_defense_matches_jax(defense):
    assert tdefense.DEFENSE_TYPES == jdefense.DEFENSE_TYPES
    dt = tdefense.FedMLDefender(_args(defense))
    dj = jdefense.FedMLDefender(_args(defense))
    for r in range(3):
        mat, w = _matrix(10 + r)
        ids = np.array([3, 0, 7, 11, 1, 5, 9, 2]) if r % 2 else np.arange(K)
        key = prng.fold_in(prng.PRNGKey(r), 1000033)
        vt, it = dt.defend_matrix(torch.from_numpy(mat), w, key, ids)
        vj, ij = dj.defend_matrix(jnp.asarray(mat), w, jnp.asarray(key), ids)
        tol = FG_TOL if defense == "foolsgold" else {}
        _close(vt, vj, **tol)
        vt_, vj_ = _verdict_t(it, K), jdefense.verdict_from_info(ij, K)
        assert (vt_ is None) == (vj_ is None)
        if vt_ is not None:
            _close(vt_, vj_, **tol)


@pytest.mark.parametrize("defense", ["multi_krum", "coordinate_median"])
def test_defend_stacked_tree_matches_jax(defense):
    """``FedMLDefender.defend``: client updates stacked per leaf -> the
    defended update in the tree's own layout (flax order and the Dense
    transpose undone)."""
    from fedml_tpu_torch.interop import flax_to_state_dict
    rng = np.random.default_rng(3)
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    tree = {"Dense_0": {"kernel": r(K, 4, 3), "bias": r(K, 3)},
            "Conv_0": {"kernel": r(K, 3, 3, 1, 2)}}
    port = {}
    for k in ("Dense_0.weight", "Dense_0.bias", "Conv_0.kernel"):
        path = k.replace("weight", "kernel").split(".")
        leaf = tree[path[0]][path[1]]
        port[k] = torch.from_numpy(np.ascontiguousarray(
            leaf.transpose(0, 2, 1) if k.endswith("weight") else leaf))
    w = np.linspace(1, 2, K).astype(np.float32)
    vt, _ = tdefense.FedMLDefender(_args(defense)).defend(port, w)
    vj, _ = jdefense.FedMLDefender(_args(defense)).defend(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(w))
    want = flax_to_state_dict(jax.device_get(vj))
    assert list(vt) == list(port)
    for k in want:
        _close(vt[k], want[k])


def _jax_sharded(mesh, mat, w, defense, hp, state, ids, key):
    out = jsharded.defend_matrix_sharded(
        mesh, "client", jnp.asarray(mat), jnp.asarray(w), defense, hp=hp,
        state=state, ids=jnp.asarray(ids, jnp.int32),
        defense_key=jnp.asarray(key), return_verdict=True)
    return out


@pytest.mark.parametrize("defense", tdefense.DEFENSE_TYPES)
def test_sharded_defense_matches_jax(mesh1, defense):
    dfd = _args(defense)
    hp_t = tsharded.DefenseHP.from_defender(tdefense.FedMLDefender(dfd))
    hp_j = jsharded.DefenseHP.from_defender(jdefense.FedMLDefender(dfd))
    assert hp_t.__dict__ == hp_j.__dict__
    st_t = st_j = None
    stateful = tsharded.is_stateful(defense)
    assert stateful == jsharded.is_stateful(defense)
    for r in range(3):
        mat, w = _matrix(20 + r)
        ids = np.array([3, 0, 7, 11, 1, 5, 9, 2]) if r % 2 else np.arange(K)
        key = prng.fold_in(prng.PRNGKey(r), 1000033)
        if stateful and st_t is None:
            st_t = tsharded.defense_state_init(defense, 12, D, "cpu")
            st_j = jax.tree_util.tree_map(
                jnp.asarray, jsharded.defense_state_init(defense, 12, D))
        out_t = tsharded.defend_matrix_sharded(
            torch.from_numpy(mat), torch.from_numpy(w), defense, hp=hp_t,
            state=st_t, ids=torch.from_numpy(ids), defense_key=key,
            return_verdict=True)
        out_j = _jax_sharded(mesh1, mat, w, defense, hp_j, st_j, ids, key)
        tol = FG_TOL if defense == "foolsgold" else {}
        _close(out_t[0], out_j[0], **tol)
        _close(out_t[-1], out_j[-1], **tol)
        if stateful:
            st_t, st_j = out_t[1], out_j[1]
            for k in st_j:
                _close(st_t[k], st_j[k])


@pytest.mark.parametrize("defense", ["coordinate_median", "trimmed_mean",
                                     "krum", "multi_krum", "bulyan"])
def test_ties_even_k_duplicate_rows(mesh1, defense):
    """Duplicate rows and an even K: the median averages the two middle
    values and selections break ties toward the lower index, as in JAX
    (``torch.median`` and ``torch.topk`` would not)."""
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(3, D)).astype(np.float32)
    mat = rows[[0, 1, 0, 2, 1, 0]]                      # K = 6, duplicates
    w = np.ones(6, np.float32)
    args = _args(defense, byzantine_client_num=1, krum_param_m=2)
    vt, it = tdefense.FedMLDefender(args).defend_matrix(
        torch.from_numpy(mat), w, prng.PRNGKey(0))
    vj, ij = jdefense.FedMLDefender(args).defend_matrix(
        jnp.asarray(mat), w, jax.random.PRNGKey(0))
    _close(vt, vj)
    if "selected" in ij:
        np.testing.assert_array_equal(np.asarray(it["selected"]),
                                      np.asarray(ij["selected"]))
    hp = tsharded.DefenseHP(byzantine_count=1, multi_k=2)
    out_t = tsharded.defend_matrix_sharded(
        torch.from_numpy(mat), torch.from_numpy(w), defense, hp=hp,
        return_verdict=True)
    out_j = _jax_sharded(mesh1, mat, w, defense,
                         jsharded.DefenseHP(byzantine_count=1, multi_k=2),
                         None, np.arange(6), prng.PRNGKey(0))
    _close(out_t[0], out_j[0])
    np.testing.assert_array_equal(out_t[-1].numpy(), np.asarray(out_j[-1]))
    if defense == "coordinate_median":
        assert not torch.equal(out_t[0], torch.median(
            torch.from_numpy(mat), dim=0).values)


@pytest.mark.parametrize("tol", [1e-3, 0.05])
def test_rfa_tolerance_stop_matches_jax(mesh1, tol):
    """``rfa_tol > 0``: the port runs the full trip count with the
    estimate frozen once it stops moving, JAX a ``while_loop``; same
    estimate, same step count on the host kernel."""
    mat, w = _matrix(7)
    vt, it = robust_agg.geometric_median(torch.from_numpy(mat),
                                         torch.from_numpy(w), iters=20,
                                         tol=tol)
    from fedml_tpu.core.security.defense import robust_agg as jra
    vj, ij = jra.geometric_median(jnp.asarray(mat), jnp.asarray(w),
                                  iters=20, tol=tol)
    _close(vt, vj)
    assert int(it["iters_run"]) == int(ij["iters_run"]) < 20
    hp = tsharded.DefenseHP(rfa_iters=20, rfa_tol=tol)
    out_t = tsharded.defend_matrix_sharded(torch.from_numpy(mat),
                                           torch.from_numpy(w), "rfa", hp=hp)
    out_j = jsharded.defend_matrix_sharded(
        mesh1, "client", jnp.asarray(mat), jnp.asarray(w), "rfa",
        hp=jsharded.DefenseHP(rfa_iters=20, rfa_tol=tol))
    _close(out_t, out_j)
