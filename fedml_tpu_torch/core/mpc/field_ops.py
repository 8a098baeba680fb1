"""Finite-field arithmetic for secure aggregation over GF(p), p = 2^31 - 1
(counterpart of ``fedml_tpu/core/mpc/field_ops.py``).

The JAX package keeps field elements in uint32 lanes and multiplies by
16-bit limbs, because a TPU has no fast int64. torch's ``uint32`` is a
limited dtype (``%``, shifts and sums are missing or promote, on the card
especially), so here a field element is a uint32 value held in an
``int64`` tensor, on whatever device the tensor lives: a sum of two
elements stays below 2^32, a product below 2^62, so ``(a * b) % p`` is
exact and equals the JAX package's limb product bit for bit. Values
become uint32 again only at the boundary (the wire's numpy ``uint32``).

``quantize`` / ``dequantize`` reproduce the JAX package's float32 path:
``round`` (half to even) of ``x * 2^16`` in float32, the clip at
``+-2^29``, and a signed value of at most 2^30 converted to float32
through int32, as XLA converts it.

The numpy host helpers (``np_*``, ``np_inv``, ``lagrange_coeffs_at``:
coding math on small arrays) are a copy.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from ... import prng

P = np.uint32(2**31 - 1)  # Mersenne prime 2147483647
_P_I = int(P)


# ---------------------------------------------------------------------------
# torch path: uint32 values in int64 lanes, on the tensors' device
# ---------------------------------------------------------------------------

def lanes(a, device=None) -> torch.Tensor:
    """``a`` (a tensor, or a numpy / Python array of uint32 values) as an
    ``int64`` tensor, on ``device`` if given, else where it lies."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.asarray(a).astype(np.int64))
    a = a.to(torch.int64)
    return a if device is None else a.to(device)


def to_uint32(a: torch.Tensor) -> np.ndarray:
    """Field elements as the wire's host ``uint32`` array: one copy off
    the device, in 32-bit words (every value is below 2^31)."""
    return a.to(torch.int32).cpu().numpy().view(np.uint32)


def ff_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p for a, b in [0, p): one conditional subtract."""
    s = lanes(a) + lanes(b)
    return torch.where(s >= _P_I, s - _P_I, s)


def ff_neg(a: torch.Tensor) -> torch.Tensor:
    a = lanes(a)
    return torch.where(a == 0, a, _P_I - a)


def ff_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ff_add(a, ff_neg(b))


def _fold31(x: torch.Tensor) -> torch.Tensor:
    """Reduce a value < 2^32 mod p via the Mersenne identity
    x = (x >> 31) + (x & (2^31-1)) (mod p)."""
    x = lanes(x)
    y = (x >> 31) + (x & _P_I)
    return torch.where(y >= _P_I, y - _P_I, y)


def ff_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod p: the product of two elements is below 2^62."""
    return (lanes(a) * lanes(b)) % _P_I


def ff_random(key: np.ndarray, shape: Tuple[int, ...],
              device="cpu") -> torch.Tensor:
    """Field elements in [0, p) from ``key``: ``jax.random.bits`` (the
    port's :func:`~fedml_tpu_torch.prng.bits_t`, bit for bit) folded once
    (bias 2^-31, negligible for masking)."""
    shape = tuple(int(s) for s in np.atleast_1d(shape))
    n = int(np.prod(shape))
    return _fold31(prng.bits_t(key, n, device)).reshape(shape)


# ---------------------------------------------------------------------------
# quantization: float vector <-> field vector
# ---------------------------------------------------------------------------

def quantize(x: torch.Tensor, frac_bits: int = 16) -> torch.Tensor:
    """Signed float -> field element: q = round(x * 2^frac_bits) in
    float32 (half to even), clipped to +-2^29 so sums of many clients stay
    decodable; negatives are p - |q|. On ``x``'s device."""
    scaled = torch.round(x.to(torch.float32) * (2.0 ** frac_bits))
    lim = 2.0 ** 29
    scaled = torch.clamp(scaled, -lim, lim)
    mag = scaled.abs().to(torch.int64)
    return torch.where(scaled >= 0, mag, _P_I - mag)


def dequantize(q: torch.Tensor, frac_bits: int = 16) -> torch.Tensor:
    """Field element -> signed float32; values above p/2 are negative.
    The signed value (< 2^30) goes to float32 through int32, as the JAX
    package converts it."""
    q = lanes(q)
    neg = q > (_P_I // 2)
    signed = torch.where(neg, q - _P_I, q)
    return signed.to(torch.int32).to(torch.float32) / (2.0 ** frac_bits)


# ---------------------------------------------------------------------------
# host (numpy uint64) path — coding math on small arrays (a copy)
# ---------------------------------------------------------------------------

def np_mod(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint64) % np.uint64(_P_I)


def np_mul(a, b) -> np.ndarray:
    return (np.asarray(a, np.uint64) * np.asarray(b, np.uint64)) % np.uint64(_P_I)


def np_add(a, b) -> np.ndarray:
    return (np.asarray(a, np.uint64) + np.asarray(b, np.uint64)) % np.uint64(_P_I)


def np_sub(a, b) -> np.ndarray:
    return (np.asarray(a, np.uint64) + np.uint64(_P_I)
            - np.asarray(b, np.uint64) % np.uint64(_P_I)) % np.uint64(_P_I)


def np_pow(base: int, exp: int) -> int:
    return pow(int(base), int(exp), _P_I)


def np_inv(a: Union[int, np.ndarray]):
    """Modular inverse by Fermat's little theorem (p prime)."""
    if np.isscalar(a) or np.asarray(a).ndim == 0:
        return np_pow(int(a), _P_I - 2)
    flat = [np_pow(int(v), _P_I - 2) for v in np.asarray(a).ravel()]
    return np.asarray(flat, np.uint64).reshape(np.asarray(a).shape)


def lagrange_coeffs_at(xs: np.ndarray, x0: int = 0) -> np.ndarray:
    """Lagrange basis coefficients l_i(x0) over the field for interpolation
    points ``xs`` (used by Shamir reconstruction and LCC decoding)."""
    xs = np.asarray(xs, np.uint64)
    n = len(xs)
    out = np.zeros(n, np.uint64)
    for i in range(n):
        num, den = 1, 1
        for j in range(n):
            if j == i:
                continue
            num = (num * ((x0 - int(xs[j])) % _P_I)) % _P_I
            den = (den * ((int(xs[i]) - int(xs[j])) % _P_I)) % _P_I
        out[i] = (num * np_pow(den, _P_I - 2)) % _P_I
    return out
