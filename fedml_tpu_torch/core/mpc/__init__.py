"""Secure multi-party computation math (counterpart of
``fedml_tpu/core/mpc``): finite-field ops over p = 2^31 - 1 (torch, on the
tensors' device), Shamir/BGW secret sharing, SecAgg masking, and
LightSecAgg Lagrange-coded masks. ``channels`` (X25519 + ChaCha20-Poly1305)
needs the ``cryptography`` package and is not imported here, as in the JAX
package."""

from .field_ops import (P, dequantize, ff_add, ff_mul, ff_neg, ff_random,
                        ff_sub, quantize)
from .secagg import (SecAggClient, expand_mask, mask_vector, pairwise_seed,
                     secagg_unmask, shamir_reconstruct, shamir_share,
                     sum_mod_p)
from .lightsecagg import (aggregate_encoded, decode_aggregate_mask,
                          lcc_decode, lcc_encode, mask_encoding)

__all__ = ["P", "quantize", "dequantize", "ff_add", "ff_sub", "ff_neg",
           "ff_mul", "ff_random", "shamir_share", "shamir_reconstruct",
           "expand_mask", "pairwise_seed", "mask_vector", "sum_mod_p",
           "SecAggClient", "secagg_unmask", "mask_encoding",
           "aggregate_encoded", "decode_aggregate_mask", "lcc_encode",
           "lcc_decode"]
