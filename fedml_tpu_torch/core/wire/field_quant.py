"""Lane-packed quantization into GF(2**31 - 1) for SecAgg-compatible
compression (a copy of ``fedml_tpu/core/wire/field_quant.py``).

Secure aggregation (Bonawitz et al., CCS'17; ``core/mpc/secagg.py``)
sums *masked* vectors mod ``p = 2**31 - 1`` — 4 B per coordinate on the
wire regardless of model precision. This module quantizes client deltas
to ``b``-bit unsigned lanes and packs several lanes per uint32 field
element so the masked vector shrinks by the lane count ``L`` while the
masked sum stays **bit-exact**:

* lane width  ``w = b + ceil(log2(k_max))`` reserves headroom for the
  sum of up to ``k_max`` clients per lane;
* lanes/elem  ``L = 30 // w`` keeps every packed element — and the
  *integer* sum of ``k_max`` packed elements — strictly below
  ``2**30 < p``, so mod-p addition never wraps and per-lane sums can be
  recovered with plain shifts.

Overflow proof (the property ``test_wire.py`` pins): each lane value is
in ``[0, 2**b - 1]`` (signed values offset by ``2**(b-1)``), so a lane
sum over ``K <= k_max`` clients is at most ``k_max * (2**b - 1)
<= 2**w - 1`` — lanes never carry into each other — and the packed sum
is at most ``sum_j (2**w - 1) * 2**(w*j) = 2**(w*L) - 1 <= 2**30 - 1
< p``. Hence ``sum_i (q_i + m_i) - sum_i m_i  (mod p)`` equals the true
integer sum of the packed vectors, and unmasking is exact: masks cancel
bit-for-bit, quantization is the only lossy step (stochastic rounding +
clipping, both absorbed by the caller's error-feedback residual).

Wire cost per f32 coordinate: ``4 / L`` bytes — e.g. 4-bit lanes with
``k_max = 4`` give ``w = 6, L = 5`` → 0.8 B/coord (5x); 8-bit lanes
with ``k_max = 16`` give ``w = 12, L = 2`` → 2 B/coord.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

# Packed elements (and their k_max-sums) are kept below 2**30; the field
# prime is 2**31 - 1, so sums mod p equal the true integer sums.
_PACK_BITS = 30
FIELD_P = int(2**31 - 1)

LANE_BITS_CHOICES = (4, 8, 16)


@dataclass(frozen=True)
class LanePlan:
    """Static packing geometry shared by every client and the server for
    one secure-aggregation session. ``bits`` is the signed quantization
    width per value; ``k_max`` the maximum number of summands a lane
    must hold without carrying."""

    bits: int
    k_max: int

    def __post_init__(self) -> None:
        if self.bits not in LANE_BITS_CHOICES:
            raise ValueError(
                f"lane bits must be one of {LANE_BITS_CHOICES}, "
                f"got {self.bits}")
        if self.k_max < 1:
            raise ValueError(f"k_max must be >= 1, got {self.k_max}")
        if self.width > _PACK_BITS:
            raise ValueError(
                f"lane width {self.width} (= {self.bits} bits + headroom "
                f"for k_max={self.k_max}) exceeds {_PACK_BITS}-bit field "
                "budget — lower bits or k_max")

    @property
    def width(self) -> int:
        """Per-lane width incl. sum headroom: ``b + ceil(log2(k_max))``."""
        return self.bits + max(0, math.ceil(math.log2(self.k_max)))

    @property
    def lanes(self) -> int:
        """Quantized values packed per uint32 field element."""
        return _PACK_BITS // self.width

    @property
    def offset(self) -> int:
        """Unsigned offset: signed value ``v`` is stored as ``v + 2**(b-1)``."""
        return 1 << (self.bits - 1)

    @property
    def qmax(self) -> int:
        """Largest signed magnitude representable: ``2**(b-1) - 1``."""
        return (1 << (self.bits - 1)) - 1

    def packed_len(self, d: int) -> int:
        return -(-d // self.lanes)

    def bytes_per_coord(self) -> float:
        """Wire bytes per f32 coordinate of the masked vector."""
        return 4.0 / self.lanes

    def to_wire(self) -> dict:
        return {"bits": int(self.bits), "k_max": int(self.k_max)}

    @staticmethod
    def from_wire(obj: dict) -> "LanePlan":
        return LanePlan(bits=int(obj["bits"]), k_max=int(obj["k_max"]))


def plan_for(bits: int, k_max: int) -> LanePlan:
    return LanePlan(bits=bits, k_max=k_max)


def suggest_scale(max_abs: float, plan: LanePlan) -> float:
    """Scale such that ``max_abs`` lands on the clip boundary."""
    return float(max(max_abs, 1e-30)) / float(plan.qmax)


def lane_quantize(x: np.ndarray, scale: float, plan: LanePlan,
                  rng: np.random.Generator,
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Stochastically round ``x / scale`` to signed ``bits``-wide ints,
    clip, offset to unsigned, and pack ``plan.lanes`` values per uint32.

    Returns ``(packed uint32 [packed_len], residual f32 [d])`` where the
    residual is ``x - scale * q_signed`` — the exact quantization +
    clipping error, for the caller's error-feedback accumulator.
    """
    x = np.asarray(x, np.float32)
    y = x.astype(np.float64) / float(scale)
    q = np.floor(y + rng.random(y.shape)).astype(np.int64)
    q = np.clip(q, -plan.offset, plan.qmax)
    residual = (x.astype(np.float64) - float(scale) * q).astype(np.float32)
    u = (q + plan.offset).astype(np.uint64)  # [0, 2**bits)
    packed = lane_pack(u, plan)
    return packed, residual


def lane_pack(u: np.ndarray, plan: LanePlan) -> np.ndarray:
    """Pack unsigned lane values ``u`` (each < 2**bits) into uint32
    field elements. Tail lanes are padded with ``plan.offset`` (encoded
    zero) so they dequantize to exactly 0 after the per-lane ``K *
    offset`` subtraction."""
    u = np.asarray(u, np.uint64)
    L, w = plan.lanes, plan.width
    d = u.shape[0]
    dp = plan.packed_len(d)
    full = np.full(dp * L, plan.offset, np.uint64)
    full[:d] = u
    lanes = full.reshape(dp, L)
    shifts = (np.arange(L, dtype=np.uint64) * np.uint64(w))
    packed = (lanes << shifts[None, :]).sum(axis=1, dtype=np.uint64)
    return packed.astype(np.uint32)


def lane_unpack_sum(total: np.ndarray, k: int, plan: LanePlan,
                    d: int) -> np.ndarray:
    """Recover per-lane signed sums from ``total = sum_i packed_i``
    (mod p — exact by the overflow bound), for ``k`` actual summands.
    Returns int64 ``[d]``: ``sum_i q_signed_i`` per coordinate."""
    if k > plan.k_max:
        raise ValueError(
            f"{k} summands exceed the lane plan's k_max={plan.k_max} — "
            "lane sums may have carried; aborting rather than decoding "
            "corrupt lanes")
    t = np.asarray(total, np.uint64)
    L, w = plan.lanes, plan.width
    mask = np.uint64((1 << w) - 1)
    lanes = np.empty((t.shape[0], L), np.int64)
    for j in range(L):
        lanes[:, j] = ((t >> np.uint64(w * j)) & mask).astype(np.int64)
    lanes -= int(k) * plan.offset
    return lanes.reshape(-1)[:d]


def lane_dequantize_sum(total: np.ndarray, k: int, scale: float,
                        plan: LanePlan, d: int) -> np.ndarray:
    """Float sum of the ``k`` quantized vectors whose packed mod-p sum
    is ``total``: unpack lane sums, remove the ``k * offset`` bias, and
    rescale."""
    s = lane_unpack_sum(total, k, plan, d)
    return (s.astype(np.float64) * float(scale)).astype(np.float32)


def field_encode(delta: np.ndarray, scale: float, plan: LanePlan,
                 residual: Optional[np.ndarray],
                 rng: np.random.Generator,
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Error-feedback wrapper around :func:`lane_quantize`: adds the
    carried residual before quantizing and returns the new residual.
    This is the sparsify/quantize stage of the secure uplink — the
    caller masks the returned packed vector (mod p) and ships it."""
    delta = np.asarray(delta, np.float32)
    comp = delta if residual is None else delta + residual
    return lane_quantize(comp, scale, plan, rng)
