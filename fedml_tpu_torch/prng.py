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
  mantissa-filled into ``[1, 2)`` and shifted down by 1;
* ``gumbel(key, n)`` -> ``-log(-log(uniform(key, n, minval=tiny)))``
  (``jax.random``'s default "low" mode), and ``categorical(key, logits)``
  -> ``argmax(logits + gumbel(key, len(logits)))``: the serving path's
  seeded sampling.

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


# Cephes' logf coefficients, as XLA's CPU backend evaluates them
_LOG_P = tuple(np.float32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))


def _fma(a: np.ndarray, b: np.ndarray, c) -> np.ndarray:
    """float32 fused multiply-add: the product of two float32 values is
    exact in float64, so one float64 add and one rounding to float32."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def uniform(key: np.ndarray, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, (n,), minval=, maxval=)``: float32 in
    ``[minval, maxval)``, computed as XLA does on the CPU:
    ``max(minval, fma(f, maxval - minval, minval))`` for ``f`` in
    ``[0, 1)``."""
    b0, b1 = threefry2x32(key, *_counters(int(n)))
    bits = (b0 ^ b1) >> np.uint32(32 - 23)
    floats = (bits | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, _fma(floats, np.float32(hi - lo), lo))


def xla_log(x: np.ndarray) -> np.ndarray:
    """Natural log of positive normal float32 values, bit-equal to
    ``jnp.log`` on the CPU. XLA does not round log correctly: it
    evaluates Cephes' polynomial (frexp into ``[sqrt(1/2), sqrt(2))``,
    degree-9 odd part in three fused multiply-add chains) and numpy's or
    torch's log differ from it by an ulp in ~10 % of inputs. A sampled
    token depends on those ulps only at near ties, but this keeps the
    Gumbel noise itself bit-equal."""
    m, e = np.frexp(np.asarray(x, np.float32))
    m, e = m.astype(np.float32), e.astype(np.float32)
    low = m < np.float32(0.707106781186547524)
    e = e - low.astype(np.float32)
    x = (m - np.float32(1)) + np.where(low, m, np.float32(0))
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = _fma(_fma(np.full_like(x, p[0]), x, p[1]), x, p[2])
    y1 = _fma(_fma(np.full_like(x, p[3]), x, p[4]), x, p[5])
    y2 = _fma(_fma(np.full_like(x, p[6]), x, p[7]), x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * np.float32(-2.12194440e-4))
    x = (x - x2 * np.float32(0.5)) + y
    return x + e * np.float32(0.693359375)


def gumbel(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.gumbel(key, (n,))`` in float32, mode "low" (jax's
    default): ``-log(-log(u))`` with ``u`` uniform in ``[tiny, 1)``."""
    tiny = np.finfo(np.float32).tiny
    u = uniform(key, n, minval=tiny, maxval=1.0)
    return -xla_log(-xla_log(u))


def categorical(key: np.ndarray, logits: np.ndarray) -> int:
    """``jax.random.categorical(key, logits)`` for one float32 row: the
    Gumbel-max trick, ``argmax(logits + gumbel)`` (first index on a
    tie, as ``jnp.argmax``)."""
    row = np.asarray(logits, np.float32)
    return int(np.argmax(gumbel(key, row.shape[-1]) + row))


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
