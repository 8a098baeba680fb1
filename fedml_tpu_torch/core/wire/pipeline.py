"""The composable wire pipeline: delta → sparsify/quantize → mask →
frame (a copy of ``fedml_tpu/core/wire/pipeline.py``; it imports the
port's compression and codec).

Every transport funnels its model-bearing messages through the same
four stages; each stage is a small stateless function here (state —
error-feedback residuals, broadcast bases — stays on the owning
manager, which is also what the checkpoint satellites persist):

====================  =======================================================
stage                 implementation
====================  =======================================================
delta                 subtract the shared base the receiver already holds
                      (``encode_update(base=...)`` / ``decode_update``)
sparsify/quantize     QSGD / top-k / rand-k with per-sender error feedback
                      (``utils/compression.ef_compress_vec`` — wire format
                      unchanged, so knob-off bytes stay pinned), or lane-
                      packed field quantization for masked uplinks
                      (:mod:`.field_quant`)
mask                  pairwise + self masks mod p (``core/mpc/secagg``) —
                      applied to the *packed* field vector, which is what
                      makes compression SecAgg-compatible
frame                 msgpack framing in ``Message.encode`` (ext-type numpy)
====================  =======================================================

When no knob is on, ``encode_update`` returns ``payload=None`` and the
caller ships its dense tree exactly as before — byte-identity on every
transport is pinned by ``tests/test_comm_compression.py`` and
``tests/test_wire.py``.

The per-stage byte ledger (``record_update_stages``) attributes raw vs
post-sparsify vs post-mask bytes by message type into ``WIRE_STATS``
and ``core/obs`` metrics so ``metrics_snapshot``/``trace_report`` show
where the wire bytes went.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ...utils.compression import (CommCompressionSpec, decompress_vec,
                                  ef_compress_vec, is_compressed_payload)
from ..distributed.communication.message import WIRE_STATS, dumps_tree
from .field_quant import LanePlan, field_encode, lane_dequantize_sum

__all__ = [
    "EncodedUpdate", "encode_update", "decode_update", "payload_nbytes",
    "record_update_stages", "mask_packed", "unmask_sum",
]

# Ledger stage names (satellite: bytes per pipeline stage by msg type).
STAGE_RAW = "raw"                # dense f32 equivalent of the update
STAGE_SPARSIFIED = "sparsified"  # after sparsify/quantize (blob bytes)
STAGE_MASKED = "masked"          # after mod-p masking (field vector bytes)
STAGE_FRAMED = "framed"          # full encoded message (msgpack framing)


@dataclass
class EncodedUpdate:
    """Result of the sparsify/quantize stage for one uplink."""

    payload: Optional[dict]          # compression blob; None = ship dense
    residual: Optional[np.ndarray]   # updated error-feedback residual
    raw_bytes: int                   # dense f32 bytes of the update
    payload_bytes: int               # wire bytes of the blob (0 if dense)


def payload_nbytes(obj) -> int:
    """Honest wire size of a payload: its msgpack framing length."""
    if obj is None:
        return 0
    return len(dumps_tree(obj))


def encode_update(vec: np.ndarray, *, base: Optional[np.ndarray] = None,
                  spec: Optional[CommCompressionSpec] = None,
                  residual: Optional[np.ndarray] = None,
                  rng=None, msg_type=None) -> EncodedUpdate:
    """Delta + sparsify/quantize stages for one model update.

    ``base`` is the reference the receiver already holds (the broadcast
    global for sync uplinks, the sender's previous reconstruction for
    gossip); ``None`` means the update is already a delta — or, with
    ``spec=None``, that the caller ships dense and this is a no-op that
    only returns byte accounting.
    """
    vec = np.asarray(vec, np.float32)
    raw = int(vec.nbytes)
    if spec is None or spec.method is None:
        return EncodedUpdate(None, residual, raw, 0)
    delta = vec if base is None else vec - np.asarray(base, np.float32)
    blob, new_res = ef_compress_vec(delta, residual, spec, rng)
    nbytes = payload_nbytes(blob)
    if msg_type is not None:
        record_update_stages(msg_type, raw=raw, sparsified=nbytes)
    return EncodedUpdate(blob, new_res, raw, nbytes)


def decode_update(payload, *, base: Optional[np.ndarray] = None,
                  ) -> np.ndarray:
    """Inverse of :func:`encode_update`'s sparsify stage: blob → delta,
    plus the receiver's base when given."""
    if not is_compressed_payload(payload):
        raise ValueError("decode_update expects a compression blob; "
                         "dense payloads never enter the pipeline")
    delta = decompress_vec(payload)
    if base is None:
        return delta
    return (np.asarray(base, np.float32) + delta).astype(np.float32)


def record_update_stages(msg_type, *, raw: Optional[int] = None,
                         sparsified: Optional[int] = None,
                         masked: Optional[int] = None) -> None:
    """Attribute bytes to pipeline stages for one message type. The
    framing stage is recorded by ``Message.encode`` itself (total bytes
    by type), so framing overhead = framed − the last pre-frame stage."""
    for stage, nbytes in ((STAGE_RAW, raw), (STAGE_SPARSIFIED, sparsified),
                          (STAGE_MASKED, masked)):
        if nbytes is not None:
            WIRE_STATS.record_stage(msg_type, stage, int(nbytes))


def mask_packed(packed: np.ndarray, mask_total: np.ndarray) -> np.ndarray:
    """Mask stage: add the combined pairwise/self mask mod p to the
    lane-packed field vector. Identical math to the dense SecAgg path —
    lanes need no special casing because mod-p sums of packed elements
    are exact (see :mod:`.field_quant`)."""
    p = np.uint64(2**31 - 1)
    q = np.asarray(packed, np.uint64)
    m = np.asarray(mask_total, np.uint64)
    return ((q + m) % p).astype(np.uint32)


def unmask_sum(total: np.ndarray, k: int, scale: float, plan: LanePlan,
               d: int) -> np.ndarray:
    """Decode stage for the server: ``total`` is the unmasked mod-p sum
    of ``k`` lane-packed client vectors; returns the float sum of the
    quantized updates (bit-identical to summing the unmasked packed
    vectors directly — the acceptance property)."""
    return lane_dequantize_sum(total, k, scale, plan, d)


__all__ += ["field_encode", "LanePlan"]
