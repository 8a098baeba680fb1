"""Paillier additively-homomorphic encryption, pure Python (a copy of
``fedml_tpu/core/fhe/paillier.py``).

The reference's FHE aggregation (``core/fhe/fhe_agg.py:10``) uses TenSEAL
CKKS (approximate HE over floats). TenSEAL is unavailable here, and CKKS
from scratch is out of scope — Paillier gives the property the FL
aggregation actually needs (ciphertext addition = plaintext addition,
exactly) with nothing but big-int arithmetic, so the aggregate of encrypted
client updates is bit-exact rather than approximate.

Packing: model updates are fixed-point-quantized and packed many slots per
ciphertext (``slot_bits`` per value, sized to hold the sum over clients),
so a 100k-parameter update needs ~100k/slots ciphertext ops, not 100k
exponentiations per value.
"""

from __future__ import annotations

import dataclasses
import secrets
from typing import List, Sequence, Tuple

import numpy as np

_SMALL_PRIMES = [3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
                 59, 61, 67, 71, 73, 79, 83, 89, 97]


def _is_probable_prime(n: int, rounds: int = 20) -> bool:
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = secrets.randbelow(n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = pow(x, 2, n)
            if x == n - 1:
                break
        else:
            return False
    return True


def _gen_prime(bits: int) -> int:
    while True:
        cand = secrets.randbits(bits) | (1 << (bits - 1)) | 1
        if _is_probable_prime(cand):
            return cand


@dataclasses.dataclass
class PublicKey:
    n: int

    @property
    def n_sq(self) -> int:
        return self.n * self.n

    def encrypt_int(self, m: int) -> int:
        """E(m) = (1 + n)^m * r^n mod n^2 (g = n+1 variant)."""
        if not 0 <= m < self.n:
            raise ValueError("plaintext out of range")
        n, n_sq = self.n, self.n_sq
        while True:
            r = secrets.randbelow(n - 1) + 1
            if r % n != 0:
                break
        return (pow(n + 1, m, n_sq) * pow(r, n, n_sq)) % n_sq

    def add(self, c1: int, c2: int) -> int:
        """Homomorphic addition: E(a) * E(b) = E(a + b)."""
        return (c1 * c2) % self.n_sq


@dataclasses.dataclass
class PrivateKey:
    public: PublicKey
    lam: int     # lcm(p-1, q-1)
    mu: int      # (L(g^lam mod n^2))^-1 mod n

    def decrypt_int(self, c: int) -> int:
        n, n_sq = self.public.n, self.public.n_sq
        x = pow(c, self.lam, n_sq)
        l_val = (x - 1) // n
        return (l_val * self.mu) % n


def keygen(bits: int = 1024, seed_primes: Tuple[int, int] = None
           ) -> Tuple[PublicKey, PrivateKey]:
    """Generate a keypair; ``seed_primes`` lets tests inject fixed primes
    (NOT for production)."""
    if seed_primes is not None:
        p, q = seed_primes
    else:
        p = _gen_prime(bits // 2)
        q = _gen_prime(bits // 2)
        while q == p:
            q = _gen_prime(bits // 2)
    import math
    n = p * q
    lam = (p - 1) * (q - 1) // math.gcd(p - 1, q - 1)
    pub = PublicKey(n)
    x = pow(n + 1, lam, n * n)
    mu = pow((x - 1) // n, -1, n)
    return pub, PrivateKey(pub, lam, mu)


# ---------------------------------------------------------------------------
# vector packing: fixed-point floats -> packed big ints -> ciphertexts
# ---------------------------------------------------------------------------

def _slot_bias(slot_bits: int, max_added: int) -> int:
    """Per-slot bias such that ``max_added`` biased slots sum without
    carrying into the neighbour: max_added * 2 * bias <= 2^slot_bits."""
    return (1 << slot_bits) // (2 * max_added)


def pack_vector(v: np.ndarray, pub: PublicKey, frac_bits: int = 16,
                slot_bits: int = 48, max_added: int = 256) -> List[int]:
    """Quantize ``v`` (float) to signed fixed point and pack into
    ciphertexts, ``slots`` values per ciphertext. Each slot carries
    ``value + bias`` (non-negative), with the bias sized so that up to
    ``max_added`` ciphertexts can be summed without slot overflow; the
    accumulated bias is removed at unpack time."""
    q = np.rint(np.asarray(v, np.float64) * (1 << frac_bits)).astype(object)
    bias = _slot_bias(slot_bits, max_added)
    lim = bias - 1
    q = np.clip(q, -lim, lim)
    slots = max((pub.n.bit_length() - 64) // slot_bits, 1)
    out: List[int] = []
    for start in range(0, len(q), slots):
        block = q[start:start + slots]
        packed = 0
        for j, val in enumerate(block):
            packed |= (int(val) + bias) << (j * slot_bits)
        out.append(pub.encrypt_int(packed))
    return out


def add_ciphertexts(cts: Sequence[List[int]], pub: PublicKey) -> List[int]:
    """Element-wise homomorphic sum of per-client ciphertext lists."""
    agg = list(cts[0])
    for ct in cts[1:]:
        agg = [pub.add(a, c) for a, c in zip(agg, ct)]
    return agg


def unpack_vector(cts: List[int], priv: PrivateKey, length: int,
                  n_added: int, frac_bits: int = 16,
                  slot_bits: int = 48, max_added: int = 256) -> np.ndarray:
    """Decrypt + unpack the SUM of ``n_added`` packed vectors (all packed
    with the same ``max_added``)."""
    if n_added > max_added:
        raise ValueError(f"{n_added} summands > packing capacity "
                         f"{max_added}")
    bias = _slot_bias(slot_bits, max_added)
    mask = (1 << slot_bits) - 1
    slots = max((priv.public.n.bit_length() - 64) // slot_bits, 1)
    vals = np.empty(length, np.float64)
    idx = 0
    for c in cts:
        m = priv.decrypt_int(c)
        for j in range(slots):
            if idx >= length:
                break
            raw = (m >> (j * slot_bits)) & mask
            vals[idx] = float(raw - n_added * bias) / (1 << frac_bits)
            idx += 1
    return vals
