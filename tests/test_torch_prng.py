"""The port's host-side threefry keys against ``jax.random``, bit for bit.

``fedml_tpu_torch.prng`` reproduces the three draws the FedAvg round takes
from JAX's generator (the per-client ``fold_in``, the loop's ``split`` and
the epoch order's ``uniform`` + ``argsort``); any bit that differs would
send a client through its batches in another order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
