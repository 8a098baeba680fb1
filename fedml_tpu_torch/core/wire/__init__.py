"""``core.wire`` — the unified secure-and-compressed wire pipeline (a
copy of ``fedml_tpu/core/wire``): one composable encode seam (delta →
sparsify/quantize → mask → frame) shared by cross-silo sync/async, hierarchical,
decentralized/gossip, cross-device, and the SecAgg/LSA masked paths.

See :mod:`.pipeline` for the stage map, :mod:`.field_quant` for the
lane-packed GF(2**31 - 1) quantization that makes compression
SecAgg-compatible, and :mod:`.adaptive` for stats-driven keep-ratio
schedules. All knobs default off with byte-identical wire.
"""

from .adaptive import AdaptiveRatioBounds, adaptive_keep_ratio
from .field_quant import (FIELD_P, LANE_BITS_CHOICES, LanePlan,
                          field_encode, lane_dequantize_sum, lane_pack,
                          lane_quantize, lane_unpack_sum, plan_for,
                          suggest_scale)
from .pipeline import (STAGE_FRAMED, STAGE_MASKED, STAGE_RAW,
                       STAGE_SPARSIFIED, EncodedUpdate, decode_update,
                       encode_update, mask_packed, payload_nbytes,
                       record_update_stages, unmask_sum)
from .state import (pack_optional_vec, unpack_optional_vec,
                    wire_checkpointer, wire_state_template)

__all__ = [
    "AdaptiveRatioBounds", "adaptive_keep_ratio",
    "FIELD_P", "LANE_BITS_CHOICES", "LanePlan", "field_encode",
    "lane_dequantize_sum", "lane_pack", "lane_quantize",
    "lane_unpack_sum", "plan_for", "suggest_scale",
    "STAGE_FRAMED", "STAGE_MASKED", "STAGE_RAW", "STAGE_SPARSIFIED",
    "EncodedUpdate", "decode_update", "encode_update", "mask_packed",
    "payload_nbytes", "record_update_stages", "unmask_sum",
    "pack_optional_vec", "unpack_optional_vec", "wire_checkpointer",
    "wire_state_template",
]
