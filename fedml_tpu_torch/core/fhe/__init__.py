"""FHE-style encrypted aggregation (a copy of
``fedml_tpu/core/fhe/__init__.py``, host-only as there; reference
``core/fhe/fhe_agg.py:10``: TenSEAL-CKKS ``fhe_enc``/``fhe_dec``/
``fhe_fedavg``). Backed here by pure-Python Paillier (:mod:`.paillier`) —
exact additive homomorphism, no native crypto dependency. The server only
ever handles ciphertexts; key generation/holding is client-side (in
deployment: threshold keygen — the shared-key stand-in is for
protocol-shape parity, like SA/LSA note)."""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

from .paillier import (PrivateKey, PublicKey, add_ciphertexts, keygen,
                       pack_vector, unpack_vector)

__all__ = ["FedMLFHE", "fhe_fedavg", "keygen", "PublicKey", "PrivateKey"]


def fhe_fedavg(vectors: Sequence[np.ndarray], weights: Sequence[float],
               pub: PublicKey, priv: PrivateKey,
               frac_bits: int = 16) -> np.ndarray:
    """Weighted FedAvg where the server-side reduction happens on
    ciphertexts: each client encrypts (w_k/W) * v_k; the 'server' multiplies
    ciphertexts (= adds plaintexts); decrypt yields the weighted average."""
    total = float(sum(weights)) or 1.0
    cts = [pack_vector(np.asarray(v) * (w / total), pub,
                       frac_bits=frac_bits)
           for v, w in zip(vectors, weights)]
    agg = add_ciphertexts(cts, pub)
    return unpack_vector(agg, priv, len(vectors[0]), n_added=len(vectors),
                         frac_bits=frac_bits)


class FedMLFHE:
    """L4 singleton consulted by the algframe hooks (reference
    ``FedMLFHE`` in ``fhe_agg.py``): enabled by ``args.enable_fhe``."""

    def __init__(self, args: Optional[Any] = None, key_bits: int = 2048):
        self.enabled = bool(getattr(args, "enable_fhe", False))
        self._pub: Optional[PublicKey] = None
        self._priv: Optional[PrivateKey] = None
        self.key_bits = int(getattr(args, "fhe_key_bits", key_bits)
                            or key_bits)
        if self.enabled and self.key_bits < 2048:
            import logging
            logging.getLogger(__name__).warning(
                "FHE key_bits=%d is below the ~2048-bit Paillier minimum — "
                "the modulus is practically factorable. NOT for production "
                "(tests may override for speed).", self.key_bits)

    def is_fhe_enabled(self) -> bool:
        return self.enabled

    def _ensure_keys(self):
        if self._pub is None:
            self._pub, self._priv = keygen(self.key_bits)

    def fhe_enc(self, vec: np.ndarray) -> List[int]:
        self._ensure_keys()
        return pack_vector(np.asarray(vec, np.float64), self._pub)

    def fhe_dec(self, cts: List[int], length: int,
                n_added: int = 1) -> np.ndarray:
        self._ensure_keys()
        return unpack_vector(cts, self._priv, length, n_added=n_added)

    def fhe_agg(self, cts_list: Sequence[List[int]]) -> List[int]:
        self._ensure_keys()
        return add_ciphertexts(cts_list, self._pub)
