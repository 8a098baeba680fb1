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
* ``normal(key, shape)`` -> ``sqrt(2) * erf_inv(uniform(key, shape,
  minval=nextafter(-1, 0), maxval=1))`` and ``laplace(key, shape)`` ->
  ``sign(u) * log1p(-|u|)`` with ``u`` uniform on ``[-1 + 2**-24, 1)``
  (``jax/_src/random.py::_normal_real`` and ``::_laplace``): the noise of
  differential privacy, of the stochastic attacks and of the noisy
  defenses. A draw of shape ``s`` hashes the flat row-major index of each
  element.

Keys are ``uint32[2]`` numpy arrays. Everything up to here is a few dozen
integer operations per draw, cheap enough to run on the host for every
client and epoch.

The noise draws are large (a client's update at the flagship's width is
855,770 normals), so ``normal`` and ``laplace`` also have a torch form
(``normal_t``, ``laplace_t``, ``normal_segments_t``) that runs on the
tensors' device: threefry2x32 in ``int64`` tensors masked to 32 bits after
each add and rotate, and the same float steps as the numpy form, whose
bits it equals on the CPU. The float steps mirror what XLA's CPU backend
computes: ``erf_inv`` is Giles' single-precision polynomial, ``log1p`` is
Cephes' rational approximation below ``sqrt(2) - 1`` and the Cephes log of
``1 + x`` above it, and every ``a * b + c`` of a polynomial is one fused
multiply-add (emulated as one float64 add of the exact float32 product,
then one rounding to float32).
"""

from __future__ import annotations

import numpy as np
import torch

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


# -- normal and laplace ------------------------------------------------------

_NEG_ONE_UP = np.nextafter(np.float32(-1), np.float32(0))   # normal's minval
_LAPLACE_LO = np.float32(-1) + np.float32(2.0 ** -24)         # laplace's
_SQRT2 = np.float32(np.sqrt(2.0))
# Cephes log1p's rational part (highest degree first), as f32 constants
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
# Giles' erf_inv: w < 5 and w >= 5 branches (highest degree first)
_ERFINV_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HI = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def _c(v) -> float:
    """A constant rounded to float32, as a Python float (exact)."""
    return float(np.float32(v))


class _NumpyOps:
    """The few array operations the float steps need, on numpy."""
    fma = staticmethod(_fma)
    sqrt = staticmethod(np.sqrt)
    div = staticmethod(np.divide)
    abs = staticmethod(np.abs)
    sign = staticmethod(np.sign)

    @staticmethod
    def where(c, a, b):
        return np.where(c, a, b).astype(np.float32)

    @staticmethod
    def wide(a):
        return a

    @staticmethod
    def full(like, v):
        return np.full(np.shape(like), np.float32(v), np.float32)

    @staticmethod
    def f32(a):
        return np.asarray(a, np.float32)

    @staticmethod
    def frexp(x):
        m, e = np.frexp(x)
        return m.astype(np.float32), e.astype(np.float32)


class _TorchOps:
    """The same operations on float32 tensors, one torch op each (so no
    op can contract a multiply and an add behind the code's back)."""

    @staticmethod
    def fma(a, b, c):
        # the float32 product is exact in float64, so one rounding at the
        # add (or none, if a backend contracts it) gives the same bits
        b = b if b.dtype == torch.float64 else b.double()
        if torch.is_tensor(c):
            return torch.addcmul(c.double(), a.double(), b).float()
        return torch.mul(a.double(), b).add_(float(c)).float()

    @staticmethod
    def wide(a):
        """``a`` in float64 once, for the multiplier of a chain of
        :meth:`fma` s."""
        return a.double()

    where = staticmethod(torch.where)
    abs = staticmethod(torch.abs)
    sign = staticmethod(torch.sign)

    @staticmethod
    def sqrt(a):
        # torch's vectorised float32 sqrt on the CPU is not always
        # correctly rounded; the float64 root rounded once is
        return torch.sqrt(a.double()).float()

    @staticmethod
    def div(a, b):
        return torch.div(a.double(), b.double()).float()

    @staticmethod
    def full(like, v):
        return torch.full_like(like, _c(v))

    @staticmethod
    def f32(a):
        return a.float()

    @staticmethod
    def frexp(x):
        m, e = torch.frexp(x)
        return m, e.float()


def _log(ops, x):
    """:func:`xla_log` on either backend."""
    m, e = ops.frexp(x)
    low = m < _c(0.707106781186547524)
    e = e - ops.where(low, 1.0, 0.0)
    x = (m - 1.0) + ops.where(low, m, 0.0)
    x2 = x * x
    x3 = ops.wide(x2 * x)
    xw = ops.wide(x)
    p = _LOG_P
    y = ops.fma(ops.fma(ops.full(x, p[0]), xw, p[1]), xw, p[2])
    y1 = ops.fma(ops.fma(ops.full(x, p[3]), xw, p[4]), xw, p[5])
    y2 = ops.fma(ops.fma(ops.full(x, p[6]), xw, p[7]), xw, p[8])
    y = ops.fma(ops.fma(y, x3, y1), x3, y2)
    y = ops.fma(y, x3, e * _c(-2.12194440e-4))
    x = (x - x2 * 0.5) + y
    return x + e * _c(0.693359375)


def _poly(ops, x, coeffs):
    p, xw = ops.full(x, 0.0), ops.wide(x)
    for c in coeffs:
        p = ops.fma(p, xw, _c(c))
    return p


def _log1p(ops, x):
    """XLA's CPU ``log1p`` in float32: Cephes' rational approximation for
    ``|x| < sqrt(2) - 1``, else ``log(1 + x)``."""
    large = _log(ops, x + 1.0)
    x2 = x * x
    small = ops.div(_poly(ops, x, _LOG1P_P), _poly(ops, x, _LOG1P_Q))
    small = ops.fma(ops.full(x2, -0.5), x2, (x * x2) * small)
    small = x + small
    return ops.where(ops.abs(x) < _c(0.41421356237309504880), small, large)


def _erf_inv(ops, x):
    """XLA's float32 ``erf_inv`` (Giles' polynomial); ``±1 -> ±inf``."""
    w = -_log1p(ops, -(x * x))
    lt = w < 5.0
    w = ops.where(lt, w - 2.5, ops.sqrt(w) - 3.0)
    p = ops.where(lt, _c(_ERFINV_LO[0]), _c(_ERFINV_HI[0]))
    ww = ops.wide(w)
    for lo, hi in zip(_ERFINV_LO[1:], _ERFINV_HI[1:]):
        p = ops.fma(p, ww, ops.where(lt, _c(lo), _c(hi)))
    inf = ops.where(x > 0, float("inf"), float("-inf"))
    return ops.where(ops.abs(x) == 1.0, inf, p * x)


def _normal_of(ops, u):
    return ops.f32(_erf_inv(ops, u) * _c(_SQRT2))


def _laplace_of(ops, u):
    return ops.f32(ops.sign(u) * _log1p(ops, -ops.abs(u)))


def _size(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


def normal(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32, on the host."""
    shape = tuple(np.atleast_1d(shape)) if np.ndim(shape) else (int(shape),)
    u = uniform(key, _size(shape), minval=_NEG_ONE_UP, maxval=1.0)
    return _normal_of(_NumpyOps, u).reshape(shape)


def laplace(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.laplace(key, shape)`` in float32, on the host."""
    shape = tuple(np.atleast_1d(shape)) if np.ndim(shape) else (int(shape),)
    u = uniform(key, _size(shape), minval=_LAPLACE_LO, maxval=1.0)
    return _laplace_of(_NumpyOps, u).reshape(shape)


# -- the torch form -----------------------------------------------------------

_MASK = 0xFFFFFFFF
# elements hashed per pass: bounds the int64/float64 temporaries (a few
# hundred MB at this size) for the [K, D] draws of the stochastic attacks
_CHUNK = 1 << 22


def _threefry_t(k0, k1, ctr: torch.Tensor):
    """:func:`threefry2x32` on ``int64`` tensors holding uint32 values:
    keys ``k0``/``k1`` (ints or tensors broadcast against ``ctr``), the
    counter pair ``(0, ctr)``. Returns the block ``(b0, b1)``; ``b0 ^
    b1`` are the 32 random bits ``jax.random`` takes from it."""
    ks2 = k0 ^ k1 ^ int(_PARITY)
    ks = (k0, k1, ks2)
    x0 = torch.zeros_like(ctr).add_(k0)
    x1 = (ctr + k1).bitwise_and_(_MASK)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_MASK)
            hi = x1 >> (32 - r)
            x1 = x1.bitwise_left_shift_(r).bitwise_and_(_MASK)
            x1.bitwise_or_(hi).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(_MASK)
    return x0, x1


def _uniform_t(bits: torch.Tensor, lo: np.float32) -> torch.Tensor:
    """:func:`uniform` on ``[lo, 1)`` from the random bits, as tensors."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    f = f - 1.0
    span = _c(np.float32(1.0) - np.float32(lo))
    return torch.clamp_min(_TorchOps.fma(f, torch.full_like(f, span),
                                         _c(lo)), _c(lo))


def _draw_t(of, lo, k0, k1, ctr: torch.Tensor) -> torch.Tensor:
    out = torch.empty(ctr.shape, dtype=torch.float32, device=ctr.device)
    for s in range(0, ctr.numel(), _CHUNK):
        e = min(s + _CHUNK, ctr.numel())
        part = lambda k: k[s:e] if torch.is_tensor(k) and k.dim() else k
        b0, b1 = _threefry_t(part(k0), part(k1), ctr[s:e])
        out[s:e] = of(_TorchOps, _uniform_t(b0.bitwise_xor_(b1), lo))
    return out


def _ints(key: np.ndarray):
    """A key's two words as Python ints: the device ops take them as
    scalars, so drawing on the card copies nothing from the host (a copy
    from pageable memory would wait for the card's queue)."""
    return int(key[0]), int(key[1])


def _flat_draw_t(of, lo, key, shape, device) -> torch.Tensor:
    shape = tuple(np.atleast_1d(shape)) if np.ndim(shape) else (int(shape),)
    ctr = torch.arange(_size(shape), dtype=torch.int64, device=device)
    return _draw_t(of, lo, *_ints(key), ctr).reshape(shape)


def normal_t(key: np.ndarray, shape, device) -> torch.Tensor:
    """:func:`normal` drawn on ``device`` (same bits on the CPU)."""
    return _flat_draw_t(_normal_of, _NEG_ONE_UP, key, shape, device)


def laplace_t(key: np.ndarray, shape, device) -> torch.Tensor:
    """:func:`laplace` drawn on ``device`` (same bits on the CPU)."""
    return _flat_draw_t(_laplace_of, _LAPLACE_LO, key, shape, device)


def split_t(key: np.ndarray, num: int, device) -> torch.Tensor:
    """:func:`split` computed on ``device``: ``[num, 2]`` ``int64``."""
    ctr = torch.arange(int(num), dtype=torch.int64, device=device)
    return torch.stack(_threefry_t(*_ints(key), ctr), dim=1)


def segments_t(sizes, device):
    """``(segment id, index within the segment, number of segments)`` of
    every element of the concatenation of segments of ``sizes``: the
    per-element key row and counter of :func:`normal_segments_t`. Build
    once per layout."""
    sizes_t = torch.as_tensor(np.asarray(sizes, np.int64), device=device)
    seg = torch.repeat_interleave(
        torch.arange(len(sizes), dtype=torch.int64, device=device), sizes_t)
    starts = torch.cumsum(sizes_t, 0) - sizes_t
    return (seg, torch.arange(seg.numel(), dtype=torch.int64,
                              device=device) - starts[seg], len(sizes))


def _segments_draw_t(of, lo, rng, segments) -> torch.Tensor:
    seg, ctr, n = segments
    k = split_t(rng, n, ctr.device)
    return _draw_t(of, lo, k[seg, 0], k[seg, 1], ctr)


def normal_segments_t(rng: np.ndarray, segments) -> torch.Tensor:
    """The concatenation of ``normal(split(rng, n)[i], sizes[i])`` over
    the ``n`` segments (:func:`segments_t`): the per-leaf noise of a
    parameter tree, drawn in one pass on the segments' device (the keys
    split there too)."""
    return _segments_draw_t(_normal_of, _NEG_ONE_UP, rng, segments)


def laplace_segments_t(rng: np.ndarray, segments) -> torch.Tensor:
    """:func:`normal_segments_t` for ``laplace``."""
    return _segments_draw_t(_laplace_of, _LAPLACE_LO, rng, segments)


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
