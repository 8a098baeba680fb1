"""The port's threefry keys and draws against ``jax.random``, bit for bit.

``fedml_tpu_torch.prng`` reproduces the three draws the FedAvg round takes
from JAX's generator (the per-client ``fold_in``, the loop's ``split`` and
the epoch order's ``uniform`` + ``argsort``); any bit that differs would
send a client through its batches in another order. ``normal`` and
``laplace`` (the noise of DP, attacks and defenses) are held bit for bit
too, and their torch form (the one that runs on the card) to the numpy
form.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu_torch import prng

pytestmark = pytest.mark.torch_port

SEEDS = [0, 1, 7, 12345, 2**31 - 1, 2**32 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_fold_in_bit_equal(seed):
    k, kj = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(k, np.asarray(kj))
    for num in (2, 3, 8):
        np.testing.assert_array_equal(prng.split(k, num),
                                      np.asarray(jax.random.split(kj, num)))
    for d in (0, 1, 63, 999983, 2**31 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(k, d), np.asarray(jax.random.fold_in(kj, d)))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("n", [1, 2, 7, 64, 257])
def test_uniform_bit_equal(seed, n):
    key = prng.fold_in(prng.split(prng.PRNGKey(seed))[1], 3)
    kj = jax.random.fold_in(jax.random.split(jax.random.PRNGKey(seed))[1], 3)
    u = prng.uniform(key, n)
    uj = np.asarray(jax.random.uniform(kj, (n,)))
    assert u.dtype == np.float32
    np.testing.assert_array_equal(u, uj)


@pytest.mark.parametrize("n_real,n_pad", [(5, 0), (3, 4), (1, 6), (9, 2)])
def test_epoch_order_matches_local_training_sort_trick(n_real, n_pad):
    """``local_training.py``'s per-epoch order: uniform keys from
    ``fold_in(data_rng, epoch)``, padded batches pushed back by +2, stable
    argsort — the first ``n_real`` slots permute exactly the real
    batches."""
    batch_real = np.array([True] * n_real + [False] * n_pad)
    rng = prng.fold_in(prng.PRNGKey(11), 4)
    data_rng = prng.split(rng)[0]
    data_rng_j = jax.random.split(jnp.asarray(rng))[0]
    for epoch in range(3):
        keys = jax.random.uniform(jax.random.fold_in(data_rng_j, epoch),
                                  (len(batch_real),))
        want = np.asarray(jnp.argsort(
            jnp.where(jnp.asarray(batch_real), keys, keys + 2.0)))
        got = prng.epoch_order(data_rng, epoch, batch_real)
        np.testing.assert_array_equal(got, want)
        assert sorted(got[:n_real]) == list(range(n_real))


def test_negative_seed_refused():
    with pytest.raises(ValueError):
        prng.PRNGKey(-1)


@pytest.mark.parametrize("seed", SEEDS[:5])
def test_gumbel_and_xla_log_bit_equal(seed):
    """The serving path's Gumbel noise: ``fold_in(PRNGKey(seed), position)``
    as the scheduler keys it, uniform in ``[tiny, 1)`` and XLA's CPU log,
    bit for bit over a byte-tokenizer vocabulary and a long row."""
    for position, n in ((0, 259), (63, 259), (255, 4096)):
        key = prng.fold_in(prng.PRNGKey(seed), position)
        kj = jax.random.fold_in(jax.random.PRNGKey(seed), position)
        np.testing.assert_array_equal(
            prng.gumbel(key, n), np.asarray(jax.random.gumbel(kj, (n,))))
        u = prng.uniform(key, n, minval=1e-3, maxval=2.0)
        np.testing.assert_array_equal(u, np.asarray(jax.random.uniform(
            kj, (n,), minval=1e-3, maxval=2.0)))
    x = np.random.RandomState(seed % 1000).rand(5000).astype(np.float32)
    x = np.concatenate([x + np.float32(1e-30), x * np.float32(1e-20), x * 7])
    np.testing.assert_array_equal(prng.xla_log(x), np.asarray(jnp.log(x)))


@pytest.mark.parametrize("temp", [0.3, 1.0, 1.7])
def test_categorical_matches_jax(temp):
    """``jax.random.categorical`` on ``logits / temp`` (the single path's
    and the scheduler's seeded sample): the same index for 40 keys."""
    rows = np.random.RandomState(3).randn(40, 259).astype(np.float32) * 3
    for i, row in enumerate(rows):
        key = prng.split(prng.PRNGKey(i))[1]
        kj = jax.random.split(jax.random.PRNGKey(i))[1]
        scaled = row / np.float32(temp)
        assert prng.categorical(key, scaled) == int(
            jax.random.categorical(kj, jnp.asarray(scaled)))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("dist", ["normal", "laplace"])
@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 4), (20000,)])
def test_normal_laplace_bit_equal(dist, seed, shape):
    """``jax.random.normal``/``laplace`` (the DP noise, the stochastic
    attacks' and defenses'): the numpy form bit for bit, and the torch
    form bit for bit with the numpy form on the CPU."""
    key = prng.fold_in(prng.split(prng.PRNGKey(seed))[1], 999983)
    kj = jax.random.fold_in(jax.random.split(jax.random.PRNGKey(seed))[1],
                            999983)
    got = getattr(prng, dist)(key, shape)
    want = np.asarray(getattr(jax.random, dist)(kj, shape))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))
    tgot = getattr(prng, f"{dist}_t")(key, shape, "cpu")
    assert tgot.dtype == torch.float32 and tuple(tgot.shape) == shape
    np.testing.assert_array_equal(_bits(tgot.numpy()), _bits(got))


def test_normal_edge_of_the_uniform():
    """``u = nextafter(-1, 0)`` (normal's minval, the largest magnitude a
    draw reaches), ``u`` = 0 and the Giles polynomial's two branches,
    against XLA's ``erf_inv`` on the same float32 inputs."""
    u = np.array([np.nextafter(np.float32(-1), np.float32(0)), 0.0, -0.5,
                  0.3, 0.9, 0.99, 0.999, 0.9999999, 1e-7, -1e-30],
                 np.float32)
    want = np.asarray(jax.scipy.special.erfinv(jnp.asarray(u))
                      * np.float32(np.sqrt(2.0)))
    np.testing.assert_array_equal(
        _bits(prng._normal_of(prng._NumpyOps, u)), _bits(want))
    np.testing.assert_array_equal(
        _bits(prng._normal_of(prng._TorchOps, torch.from_numpy(u)).numpy()),
        _bits(want))
    lo = np.float32(-1) + np.float32(2.0 ** -24)
    ul = np.array([lo, 0.0, 0.5, -0.25, 0.9999999], np.float32)
    want_l = np.asarray(jnp.sign(ul) * jnp.log1p(-jnp.abs(ul)))
    np.testing.assert_array_equal(
        _bits(prng._laplace_of(prng._NumpyOps, ul)), _bits(want_l))


def test_segments_draw_is_per_leaf_split():
    """``normal_segments_t``: one pass that equals ``normal(split(rng,
    n)[i], sizes[i])`` concatenated (the DP noise of a parameter tree),
    its keys split on the device as ``split`` does on the host."""
    rng = prng.PRNGKey(5)
    keys = prng.split(rng, 4)
    np.testing.assert_array_equal(prng.split_t(rng, 4, "cpu").numpy(),
                                  keys.astype(np.int64))
    sizes = [3, 1, 700, 40]
    got = prng.normal_segments_t(rng, prng.segments_t(sizes, "cpu"))
    want = np.concatenate([np.asarray(jax.random.normal(jnp.asarray(k),
                                                        (n,)))
                           for k, n in zip(keys, sizes)])
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    got_l = prng.laplace_segments_t(rng, prng.segments_t(sizes, "cpu"))
    want_l = np.concatenate([prng.laplace(k, n) for k, n in zip(keys, sizes)])
    np.testing.assert_array_equal(_bits(got_l.numpy()), _bits(want_l))
