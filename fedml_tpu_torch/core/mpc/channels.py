"""Authenticated pairwise channels for MPC share routing (a copy of
``fedml_tpu/core/mpc/channels.py``; it needs the ``cryptography`` package,
so ``core/mpc/__init__.py`` does not import it).

X25519 ECDH -> HKDF-SHA256 -> ChaCha20-Poly1305. The SecAgg and
LightSecAgg runtimes route Shamir shares / Lagrange-coded sub-masks
between clients *through the server*; the Bonawitz protocol
(reference ``core/mpc/secagg.py:164-213``, ``sa_message_define.py``)
assumes those channels are confidential and authenticated against the
server. This module provides them: each client advertises X25519 public
keys, every ordered client pair derives a shared AEAD key, and routed
payloads are sealed so the server relays only ciphertext.

Two independent keypairs per client, as in Bonawitz et al.:
  - the *mask* keypair (``c`` keys): its ECDH outputs seed the pairwise
    PRG masks, and its secret is Shamir-shared so the cohort can cancel a
    dropped client's masks;
  - the *channel* keypair (``s`` keys): encrypts routed shares. It is
    never Shamir-shared, so reconstructing a dropped client's mask key
    does not retroactively open their routed-share ciphertexts.

The mask PRG itself stays 31-bit-seeded GF(2^31-1) math (``field_ops``,
matching the reference's uint32-lane field); the ECDH shared secret is
hashed down to that seed.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Tuple

from cryptography.exceptions import InvalidTag
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric.x25519 import (
    X25519PrivateKey, X25519PublicKey)
from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
from cryptography.hazmat.primitives.kdf.hkdf import HKDF

from .field_ops import P

_P_I = int(P)
# X25519 secrets are 256-bit; Shamir runs over GF(2^31-1), so keys are
# shared as 24-bit limbs (11 limbs cover 264 bits), each its own share set
KEY_LIMB_BITS = 24
KEY_LIMBS = 11


class DecryptError(ValueError):
    """Routed ciphertext failed authentication (wrong pair, tampering)."""


class SecretRNG:
    """CSPRNG for SECRET protocol material (self-mask seeds, Shamir
    polynomial coefficients, LSA masks and coding noise): raw kernel
    entropy via ``os.urandom`` (one C call per draw, fast enough for
    model-dimension LSA mask arrays). NumPy's MT19937 is not a
    cryptographic generator — 624 outputs reconstruct its whole state — so
    secret field elements must not come from it. Exposes the
    ``randint(low, high, size=None)`` shape the share/mask code uses."""

    __slots__ = ()

    def _bytes(self, n: int) -> bytes:
        return os.urandom(n)

    def randbits(self, bits: int) -> int:
        return int.from_bytes(self._bytes((bits + 7) // 8),
                              "big") >> (-bits % 8)

    def randint(self, low: int, high: int, size=None):
        """Uniform over [low, high) by rejection sampling on uint64 words
        (bias-free, unlike a bare modulo)."""
        import numpy as np
        span = int(high) - int(low)
        limit = ((1 << 64) // span) * span
        if size is None:
            while True:
                v = int.from_bytes(self._bytes(8), "big")
                if v < limit:
                    return int(low) + v % span
        n = int(np.prod(size))
        out = np.empty(n, np.uint64)
        filled = 0
        while filled < n:
            raw = np.frombuffer(self._bytes(8 * (n - filled)), np.uint64)
            ok = raw[raw < limit]
            out[filled:filled + len(ok)] = ok
            filled += len(ok)
        return (int(low) + (out % span)).reshape(size)


def secret_rng() -> SecretRNG:
    """RNG for SECRET protocol material: raw ``os.urandom`` draws (see
    SecretRNG) — never ``args.random_seed``, which is public configuration
    the server also holds; a mask drawn from a public seed can simply be
    regenerated by the server, making the sealed routing worthless."""
    return SecretRNG()


class PrivateKey:
    """X25519 private key + its per-peer derivation cache. The cache lives
    ON the key object, so derived AEAD keys share the key's lifetime — no
    process-global structure retains secret material after a session's key
    is dropped (an lru_cache keyed on private bytes would)."""

    __slots__ = ("_sk", "_cache")

    def __init__(self, sk: X25519PrivateKey):
        self._sk = sk
        self._cache = {}

    def exchange(self, peer: X25519PublicKey) -> bytes:
        return self._sk.exchange(peer)

    def raw(self) -> bytes:
        return self._sk.private_bytes(serialization.Encoding.Raw,
                                      serialization.PrivateFormat.Raw,
                                      serialization.NoEncryption())


def keygen() -> Tuple[PrivateKey, bytes]:
    """Fresh X25519 keypair; returns (private, raw 32-byte public)."""
    sk = X25519PrivateKey.generate()
    pk = sk.public_key().public_bytes(serialization.Encoding.Raw,
                                      serialization.PublicFormat.Raw)
    return PrivateKey(sk), pk


def private_bytes(sk: PrivateKey) -> bytes:
    return sk.raw()


def _shared(sk: PrivateKey, peer_pk: bytes) -> bytes:
    return sk.exchange(X25519PublicKey.from_public_bytes(peer_pk))


def channel_key(sk: PrivateKey, peer_pk: bytes,
                context: bytes = b"fedml-tpu/share-routing") -> bytes:
    """Symmetric 32-byte AEAD key for this pair (same on both ends).
    Cached per (key object, peer, context): the derivation is constant for
    a session and the seal/open loops hit it O(n_clients) times per round."""
    key = sk._cache.get((peer_pk, context))
    if key is None:
        key = HKDF(algorithm=hashes.SHA256(), length=32, salt=None,
                   info=context).derive(_shared(sk, peer_pk))
        sk._cache[(peer_pk, context)] = key
    return key


def seal(sk: PrivateKey, peer_pk: bytes, plaintext: bytes,
         aad: bytes = b"") -> bytes:
    """Encrypt+authenticate for the peer; random 12-byte nonce prepended."""
    nonce = os.urandom(12)
    ct = ChaCha20Poly1305(channel_key(sk, peer_pk)).encrypt(
        nonce, plaintext, aad)
    return nonce + ct


def open_sealed(sk: PrivateKey, peer_pk: bytes, blob: bytes,
                aad: bytes = b"") -> bytes:
    try:
        return ChaCha20Poly1305(channel_key(sk, peer_pk)).decrypt(
            blob[:12], blob[12:], aad)
    except InvalidTag as e:
        raise DecryptError(
            "routed share failed authentication (wrong key pair or "
            "tampered in transit)") from e


def pair_aad(sender_idx: int, receiver_idx: int, tag: bytes = b"") -> bytes:
    """Binds a ciphertext to its (sender, receiver) pair so the server
    cannot replay one client's blob to a different recipient slot."""
    return b"%d>%d:" % (sender_idx, receiver_idx) + tag


def mask_seed(sk: PrivateKey, peer_pk: bytes) -> int:
    """Pairwise PRG seed: 128-bit hash of the ECDH secret — identical on
    both ends, replaces the reference's key-product stand-in. Full digest
    width is kept (NOT reduced mod p): the PRG only expands *outputs* in
    GF(2^31-1); a 31-bit seed space would bound mask confidentiality at
    ~2^31 regardless of the X25519 layer above it."""
    h = hashlib.sha256(b"fedml-tpu/pairwise-mask" + _shared(sk, peer_pk))
    return int.from_bytes(h.digest()[:16], "big")


def int_to_limbs(val: int, n_limbs: int) -> List[int]:
    """Split a wide secret integer into Shamir-shareable 24-bit limbs
    (each limb < 2^24 << p, its own Shamir instance over GF(2^31-1))."""
    mask = (1 << KEY_LIMB_BITS) - 1
    return [(int(val) >> (KEY_LIMB_BITS * i)) & mask for i in range(n_limbs)]


def limbs_to_int(limbs: List[int]) -> int:
    val = 0
    for i, limb in enumerate(limbs):
        val |= int(limb) << (KEY_LIMB_BITS * i)
    return val


# self-mask seeds are 128-bit (6 limbs cover 144 bits) so mask
# confidentiality is not bounded by the 31-bit share field
SEED_BITS = 128
SEED_LIMBS = 6


def key_to_limbs(sk: PrivateKey) -> List[int]:
    """Split the 32-byte secret into Shamir-shareable 24-bit limbs."""
    return int_to_limbs(int.from_bytes(private_bytes(sk), "big"), KEY_LIMBS)


def limbs_to_key(limbs: List[int]) -> PrivateKey:
    val = limbs_to_int(limbs)
    return PrivateKey(X25519PrivateKey.from_private_bytes(
        (val & ((1 << 256) - 1)).to_bytes(32, "big")))
