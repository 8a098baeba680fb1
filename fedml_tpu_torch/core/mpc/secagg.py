"""Secure aggregation (SecAgg) primitives, Bonawitz et al. style
(counterpart of ``fedml_tpu/core/mpc/secagg.py``).

* Shamir secret sharing over GF(p), the SHA-256 counter-mode mask PRG
  (``expand_mask``) and the stand-in pairwise seed: copies, on the host
  (the PRG must stay the JAX package's function, or a session mixing the
  two packages unmasks to garbage);
* the masking data path (``mask_vector``, ``sum_mod_p``): torch on the
  tensors' device, field elements as uint32 values in ``int64`` lanes
  (:mod:`.field_ops`);
* ``SecAggClient`` / ``secagg_unmask``: the protocol helpers with the
  stand-in key agreement (no ``cryptography`` needed); a client quantizes
  on its vector's device and masks on the host.

The wire protocol (advertise keys, share seeds, masked input, unmask) lives
in ``cross_silo/secagg``; this module is the math.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .field_ops import (P, ff_add, ff_sub, lagrange_coeffs_at, lanes,
                        np_mul, quantize, to_uint32)

_P_I = int(P)


# ---------------------------------------------------------------------------
# Shamir secret sharing over GF(p)  (reference BGW_encoding/decoding)
# ---------------------------------------------------------------------------

def shamir_share(secret: int, n_shares: int, threshold: int,
                 rng: np.random.RandomState) -> List[Tuple[int, int]]:
    """Split ``secret`` into ``n_shares`` points of a degree-(threshold-1)
    polynomial; any ``threshold`` shares reconstruct."""
    coeffs = [int(secret) % _P_I] + [int(rng.randint(0, _P_I))
                                     for _ in range(threshold - 1)]
    shares = []
    for xi in range(1, n_shares + 1):
        acc = 0
        for c in reversed(coeffs):  # Horner
            acc = (acc * xi + c) % _P_I
        shares.append((xi, acc))
    return shares


def shamir_reconstruct(shares: Sequence[Tuple[int, int]]) -> int:
    xs = np.asarray([s[0] for s in shares])
    ys = np.asarray([s[1] for s in shares], np.uint64)
    lag = lagrange_coeffs_at(xs, 0)
    return int(np.sum(np_mul(lag, ys) % np.uint64(_P_I)) % _P_I)


# ---------------------------------------------------------------------------
# PRG mask expansion (counter-based, deterministic per seed)
# ---------------------------------------------------------------------------

def expand_mask(seed: int, length: int) -> np.ndarray:
    """Expand a seed (any width up to 256 bits — field element or the
    128-bit seeds from ``channels``) into ``length`` field elements.
    SHA-256 counter mode — deterministic across hosts, no RNG-state
    coupling."""
    out = np.empty(length, np.uint32)
    n_blocks = -(-length // 8)  # 8 uint32 per 32-byte digest
    buf = np.empty(n_blocks * 8, np.uint32)
    sbytes = int(seed).to_bytes(32, "little")
    for b in range(n_blocks):
        d = hashlib.sha256(sbytes + b.to_bytes(4, "little")).digest()
        buf[b * 8:(b + 1) * 8] = np.frombuffer(d, np.uint32)
    out[:] = buf[:length] % np.uint32(_P_I)
    return out


def pairwise_seed(secret_i: int, public_j: int) -> int:
    """Symmetric pairwise seed derived from i's secret and j's public key.
    Stand-in for the ECDH agreement of full SecAgg (``channels.mask_seed``
    is the real one); the *protocol* shape is identical."""
    lo, hi = sorted((int(secret_i), int(public_j)))
    d = hashlib.sha256(f"{lo}:{hi}".encode()).digest()
    return int.from_bytes(d[:8], "little") % _P_I


# ---------------------------------------------------------------------------
# masking data path, on the tensors' device
# ---------------------------------------------------------------------------

def mask_vector(quantized: torch.Tensor, self_mask: torch.Tensor,
                pair_masks_add: torch.Tensor,
                pair_masks_sub: torch.Tensor) -> torch.Tensor:
    """masked = q + b_i + sum_{j>i} s_ij - sum_{j<i} s_ji  (mod p)."""
    return ff_add(ff_add(quantized, self_mask),
                  ff_sub(pair_masks_add, pair_masks_sub))


def sum_mod_p(masked: torch.Tensor) -> torch.Tensor:
    """Sum a ``[K, D]`` matrix of field elements over K, mod p: an int64
    sum is exact for K < 2^32 (each term < 2^31)."""
    return lanes(masked).sum(dim=0) % _P_I


# ---------------------------------------------------------------------------
# whole-protocol simulation helpers (tests, chip_smoke's masking algebra)
# ---------------------------------------------------------------------------

class SecAggClient:
    """One client's SecAgg state across the four protocol rounds."""

    def __init__(self, cid: int, n_clients: int, threshold: int, seed: int):
        self.cid = cid
        self.n = n_clients
        self.t = threshold
        rng = np.random.RandomState(seed)
        self.secret_key = int(rng.randint(0, _P_I))
        self.public_key = self.secret_key  # stand-in DH (see pairwise_seed)
        self.self_seed = int(rng.randint(0, _P_I))
        self._rng = rng
        self.peer_publics: Dict[int, int] = {}

    # round 1: advertise keys -> server broadcasts
    def receive_publics(self, publics: Dict[int, int]) -> None:
        self.peer_publics = dict(publics)

    # round 2: share self_seed and secret_key via Shamir
    def make_shares(self) -> Dict[int, Tuple[Tuple[int, int], Tuple[int, int]]]:
        seed_shares = shamir_share(self.self_seed, self.n, self.t, self._rng)
        key_shares = shamir_share(self.secret_key, self.n, self.t, self._rng)
        return {j: (seed_shares[j], key_shares[j]) for j in range(self.n)}

    def mask_total(self, d: int) -> np.ndarray:
        """This client's total mask over ``d`` coordinates (host uint64):
        its self mask plus its signed pairwise masks."""
        total = expand_mask(self.self_seed, d).astype(np.uint64)
        for j, pub in self.peer_publics.items():
            if j == self.cid:
                continue
            s = expand_mask(pairwise_seed(self.secret_key, pub), d).astype(np.uint64)
            if self.cid < j:
                total = (total + s) % _P_I
            else:
                total = (total + _P_I - s) % _P_I
        return total

    # round 3: masked input
    def masked_update(self, vec) -> np.ndarray:
        """``vec`` (a float tensor on any device, or a numpy array)
        quantized where it lies, then masked on the host."""
        if not torch.is_tensor(vec):
            vec = torch.from_numpy(np.asarray(vec, np.float32))
        q = to_uint32(quantize(vec)).astype(np.uint64)
        return ((q + self.mask_total(len(q))) % _P_I).astype(np.uint32)


def secagg_unmask(
    masked_sum: np.ndarray,
    surviving: Sequence[int],
    dropped: Sequence[int],
    self_seed_shares: Dict[int, List[Tuple[int, int]]],
    secret_key_shares: Dict[int, List[Tuple[int, int]]],
    publics: Dict[int, int],
    length: int,
) -> np.ndarray:
    """Server-side unmasking: subtract surviving clients' self masks
    (reconstructed from their seed shares) and cancel dropped clients'
    pairwise masks (reconstructed from their key shares)."""
    total = np.asarray(masked_sum).astype(np.uint64)
    for i in surviving:
        seed = shamir_reconstruct(self_seed_shares[i])
        total = (total + _P_I - expand_mask(seed, length).astype(np.uint64)) % _P_I
    for i in dropped:
        sk = shamir_reconstruct(secret_key_shares[i])
        for j in surviving:
            s = expand_mask(pairwise_seed(sk, publics[j]), length).astype(np.uint64)
            if i < j:   # i added +s_ij into its (lost) contribution — but i
                # dropped, so the *surviving* j subtracted/added the
                # counterpart; cancel j's leftover term
                total = (total + s) % _P_I
            else:
                total = (total + _P_I - s) % _P_I
    return total.astype(np.uint32)
