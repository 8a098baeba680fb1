"""Host-side threefry2x32 keys that reproduce ``jax.random`` bit for bit.

The federated round derives every client's data order from JAX's counter
based generator (``fedml_tpu/simulation/tpu/engine.py`` folds the client id
into the round key; ``core/algframe/local_training.py`` splits it and draws
one uniform per padded batch to order each epoch). A port that used
``torch.Generator`` there would visit batches in another order, and no
multi-batch trajectory could match the reference. So the few draws the round
needs are computed here, in numpy, exactly as JAX computes them with its
default ``threefry2x32`` implementation and ``jax_threefry_partitionable``
on (the default since jax 0.5):

* ``PRNGKey(seed)``  -> ``[0, seed & 0xFFFFFFFF]`` (64-bit types off)
* ``split(key, n)``  -> row ``i`` is ``threefry(key, (0, i))``
* ``fold_in(key, d)``-> ``threefry(key, (0, d))`` read as one key
* ``uniform(key, n)``-> ``bits = b0 ^ b1`` of ``threefry(key, (0, i))``,
  mantissa-filled into ``[1, 2)`` and shifted down by 1.

Keys are ``uint32[2]`` numpy arrays. Everything here is a few dozen integer
operations per draw, cheap enough to run on the host for every client and
epoch.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 block cipher, 20 rounds (Salmon et al. 2011), on
    uint32 arrays: the hash behind every JAX random draw."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3]
        x1 = x1 + np.uint32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a non-negative integer seed, as JAX
    computes it with 64-bit types off (its default): the seed is taken as a
    32-bit integer, so the key's high word is 0."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _counters(n: int):
    return np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``[num, 2]`` uint32 keys."""
    b0, b1 = threefry2x32(key, *_counters(int(num)))
    return np.stack([b0, b1], axis=1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``; ``data`` is taken mod 2**32."""
    b0, b1 = threefry2x32(key, [0], [int(data) & 0xFFFFFFFF])
    return np.array([b0[0], b1[0]], np.uint32)


def uniform(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.uniform(key, (n,))``: float32 in ``[0, 1)``."""
    b0, b1 = threefry2x32(key, *_counters(int(n)))
    bits = (b0 ^ b1) >> np.uint32(32 - 23)
    floats = (bits | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    return np.maximum(np.float32(0), floats)


def epoch_order(data_rng: np.ndarray, epoch: int,
                batch_real: np.ndarray) -> np.ndarray:
    """The local loop's sort-trick batch order for one epoch: a uniform key
    per padded batch slot, padded slots pushed past every real one by
    ``+2``, stable argsort (``jnp.argsort``'s default). The first
    ``sum(batch_real)`` entries are a uniform permutation of the real
    batches."""
    keys = uniform(fold_in(data_rng, epoch), len(batch_real))
    keys = np.where(batch_real, keys, keys + np.float32(2.0))
    return np.argsort(keys, kind="stable")
