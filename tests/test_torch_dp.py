"""Differential privacy of the port against the JAX package's
(``fedml_tpu/core/dp/``), on the CPU.

* the mechanisms on a parameter tree whose flax leaf order differs from
  the port's insertion order (``BasicBlock_10`` before ``BasicBlock_2``)
  and whose Dense kernel is transposed: the noise equals ``jax.random``'s
  bit for bit, coordinate for coordinate; the clip is held to the house
  float32 tolerance ``rtol=2e-4, atol=2e-5`` (the sum of squares
  associates differently);
* the RDP accountant (the port's own copy): exactly;
* ``FedMLDifferentialPrivacy`` for LDP, CDP and NbAFL, its accounting and
  its checkpointable state;
* 2-round LDP, CDP and NbAFL runs of the GPU engine and the SP loop
  against the JAX package's SP loop from the same flax parameters, at the
  house tolerance, and ``dp_epsilon_spent``.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu.data as jdata
import fedml_tpu.model as jmodel
from fedml_tpu.arguments import Arguments as JArguments
from fedml_tpu.core import dp as jdp
from fedml_tpu.core.dp import mechanisms as jmech
from fedml_tpu.core.dp import rdp_accountant as jrdp
import fedml_tpu_torch
from fedml_tpu_torch import prng
from fedml_tpu_torch.core import dp as tdp
from fedml_tpu_torch.core.dp import mechanisms as tmech
from fedml_tpu_torch.core.dp import rdp_accountant as trdp
from fedml_tpu_torch.interop import flax_to_state_dict

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5


def _flax_tree(seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"BasicBlock_2": {"Conv_0": {"kernel": r(3, 3, 2, 4)},
                             "GroupNorm_0": {"scale": r(4), "bias": r(4)}},
            "BasicBlock_10": {"Conv_0": {"kernel": r(3, 3, 4, 4)}},
            "Conv_0": {"kernel": r(3, 3, 1, 2)},
            "Dense_0": {"kernel": r(4, 5), "bias": r(5)}}


def _port(tree):
    """The port's dict of the same params, in an insertion order that
    is not flax's."""
    sd = flax_to_state_dict(tree)
    order = sorted(sd, key=lambda k: (not k.startswith("Dense"), k[::-1]))
    return {k: torch.from_numpy(sd[k].copy()) for k in order}


def _equal_tree(port, flax_tree):
    want = flax_to_state_dict(jax.device_get(flax_tree))
    assert set(port) == set(want)
    for k in want:
        np.testing.assert_array_equal(port[k].numpy(), want[k], err_msg=k)


def _close_tree(port, flax_tree):
    want = flax_to_state_dict(jax.device_get(flax_tree))
    for k in want:
        np.testing.assert_allclose(port[k].numpy(), want[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("mechanism", ["gaussian", "laplace"])
@pytest.mark.parametrize("seed", [0, 9])
def test_noise_bit_equal_in_flat_layout(mechanism, seed):
    tree = _flax_tree(seed)
    key = prng.fold_in(prng.PRNGKey(seed), 999983)
    add_t = getattr(tmech, f"add_{mechanism}_noise")
    add_j = getattr(jmech, f"add_{mechanism}_noise")
    _equal_tree(add_t(_port(tree), key, 0.37),
                add_j(jax.tree_util.tree_map(jnp.asarray, tree),
                      jnp.asarray(key), 0.37))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm(max_norm):
    tree = _flax_tree(2)
    _close_tree(tmech.clip_by_global_norm(_port(tree), max_norm),
                jmech.clip_by_global_norm(
                    jax.tree_util.tree_map(jnp.asarray, tree), max_norm))


def test_accountant_copy_matches():
    """The port's copy of ``rdp_accountant.py`` computes what the JAX
    package's does, exactly."""
    for q, sigma, steps in ((0.25, 1.1, 3), (1.0, 0.8, 5), (0.01, 4.0, 100)):
        np.testing.assert_array_equal(trdp.compute_rdp(q, sigma, steps),
                                      jrdp.compute_rdp(q, sigma, steps))
        rdp = trdp.compute_rdp(q, sigma, steps)
        assert trdp.get_privacy_spent(trdp.DEFAULT_ORDERS, rdp, 1e-5) == \
            jrdp.get_privacy_spent(jrdp.DEFAULT_ORDERS, rdp, 1e-5)
    at, aj = trdp.RDPAccountant(), jrdp.RDPAccountant()
    for _ in range(7):
        at.step(1.3, 0.5)
        aj.step(1.3, 0.5)
    assert at.get_epsilon(1e-5) == aj.get_epsilon(1e-5)
    assert trdp.DEFAULT_ORDERS == jrdp.DEFAULT_ORDERS


def _dp_args(dp_type, mechanism="gaussian"):
    return types.SimpleNamespace(enable_dp=True, dp_type=dp_type,
                                 dp_mechanism=mechanism, dp_epsilon=5.0,
                                 dp_delta=1e-5, dp_clip_norm=0.8)


@pytest.mark.parametrize("dp_type,mechanism", [
    ("local_dp", "gaussian"), ("central_dp", "gaussian"),
    ("central_dp", "laplace"), ("nbafl", "gaussian")])
def test_frame_matches_jax(dp_type, mechanism):
    ft = tdp.FedMLDifferentialPrivacy(_dp_args(dp_type, mechanism))
    fj = jdp.FedMLDifferentialPrivacy(_dp_args(dp_type, mechanism))
    assert (ft.is_local_dp_enabled(), ft.is_global_dp_enabled()) == \
        (fj.is_local_dp_enabled(), fj.is_global_dp_enabled())
    tree = _flax_tree(4)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    key = prng.fold_in(prng.PRNGKey(1), 999979)
    _close_tree(ft.clip_update(_port(tree)), fj.clip_update(jtree))
    _close_tree(ft.add_local_noise(_port(tree), key),
                fj.add_local_noise(jtree, jnp.asarray(key)))
    _equal_tree(ft.add_global_noise(_port(tree), key),
                fj.add_global_noise(jtree, jnp.asarray(key)))
    for r in range(4):
        ft.record_round(0.5)
        fj.record_round(0.5)
    assert ft.get_epsilon_spent() == fj.get_epsilon_spent() > 0
    again = tdp.FedMLDifferentialPrivacy(_dp_args(dp_type, mechanism))
    again.load_state_dict(ft.state_dict())
    assert again.get_epsilon_spent() == ft.get_epsilon_spent()


CFG = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=8,
           client_num_per_round=4, comm_round=2, epochs=1, batch_size=16,
           learning_rate=0.1, frequency_of_the_test=1, random_seed=42,
           dp_epsilon=8.0, dp_delta=1e-5, dp_clip_norm=0.5)


def _jax_init(cfg):
    jargs = JArguments(backend="sp", **cfg)
    fed, out_dim = jdata.load(jargs)
    key = jax.random.split(jax.random.PRNGKey(cfg["random_seed"]))[0]
    return jax.device_get(jmodel.create(jargs, out_dim).init(
        key, fed.train.x[0, 0]))


@pytest.mark.parametrize("dp", [
    dict(dp_type="local_dp"), dict(dp_type="central_dp"),
    dict(dp_type="central_dp", dp_mechanism="laplace"),
    dict(dp_type="nbafl")], ids=["ldp", "cdp", "cdp_laplace", "nbafl"])
def test_dp_run_matches_jax_sp(dp):
    cfg = dict(CFG, enable_dp=True, **dp)
    p0 = flax_to_state_dict(_jax_init(cfg))
    rj = fedml_tpu.run_simulation(backend="sp",
                                  args=JArguments(backend="sp", **cfg))
    want = flax_to_state_dict(jax.device_get(rj["params"]))
    for backend in ("sp", "gpu"):
        rt = fedml_tpu_torch.run_simulation(backend=backend, device="cpu",
                                            init_params=p0, **cfg)
        for k in want:
            np.testing.assert_allclose(rt["params"][k].numpy(), want[k],
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        for ht, hj in zip(rt["history"], rj["history"]):
            for k in ("train_loss", "test_loss"):
                np.testing.assert_allclose(ht[k], hj[k], rtol=RTOL,
                                           atol=ATOL, err_msg=k)
        assert rt["dp_epsilon_spent"] == pytest.approx(
            rj["dp_epsilon_spent"], rel=1e-12)
    # the noise reached the params: a run without DP ends elsewhere
    plain = fedml_tpu_torch.run_simulation(
        backend="gpu", device="cpu", init_params=p0,
        **dict(cfg, enable_dp=False))
    assert "dp_epsilon_spent" not in plain
    assert not torch.allclose(plain["params"]["Dense_0.weight"],
                              torch.from_numpy(want["Dense_0.weight"]))


def test_flat_layout_matches_jax():
    """The JAX package's flat vector of the same params (flax leaf
    order, Dense ``[in, out]``), its inverse, and the stacked matrix."""
    from fedml_tpu.core import collectives as jcol
    from fedml_tpu.core.security.defense import stack_to_matrix as jstack
    from fedml_tpu_torch.core import collectives as tcol
    tree = _flax_tree(6)
    port = _port(tree)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    vec = tcol.tree_flatten_to_vector(port)
    np.testing.assert_array_equal(
        vec.numpy(), np.asarray(jcol.tree_flatten_to_vector(jtree)))
    back = tcol.vector_to_tree_like(vec * 2, port)
    assert list(back) == list(port)
    _equal_tree(back, jcol.vector_to_tree_like(
        jcol.tree_flatten_to_vector(jtree) * 2, jtree))
    stacked = {k: torch.stack([v, -v, 3 * v]) for k, v in port.items()}
    jstacked = jax.tree_util.tree_map(
        lambda v: jnp.stack([v, -v, 3 * v]), jtree)
    np.testing.assert_array_equal(tcol.stack_to_matrix(stacked).numpy(),
                                  np.asarray(jstack(jstacked)))
