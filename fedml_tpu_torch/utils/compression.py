"""Update compression for the cross-silo wire (counterpart of
``fedml_tpu/utils/compression.py``): top-k and random-k sparsification,
QSGD stochastic int8 quantization and their error-feedback composition.

The blob :func:`ef_compress_vec` writes is the JAX package's bit for bit
— the same indices in the same order, the same ``int8`` levels, scale
and residual, the same ``uint16`` / ``int32`` index type — so port and
JAX parties can share a compressed session. That fixes four things:

* rand-k keeps the first ``k`` of ``jax.random.permutation(srng, d)``
  (``jax.random.choice(..., replace=False)``), drawn by
  :func:`fedml_tpu_torch.prng.permutation_t`;
* QSGD rounds ``floor(|x| / scale * levels + u)`` with ``u`` from
  ``jax.random.uniform(qrng)``, the multiply-add fused as XLA's CPU
  backend fuses it (one rounding);
* top-k orders the kept entries as ``jax.lax.top_k`` does: by magnitude,
  descending, ties by the lower index first (a stable descending sort);
* the residual's dequantized levels are ``q * (scale * (1 / levels))``,
  the reciprocal in float32, as XLA folds the jitted core's division by
  the constant ``levels``.

``srng, qrng = split(rng)`` as in the JAX core. The compressors run in
PyTorch on the device of the vector they are given (the cross-silo
managers hand them host arrays, so they run on the host). Keys are
``fedml_tpu_torch.prng`` keys (``uint32[2]`` arrays).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import prng
from ..constants import (COMM_BROADCAST_BF16, COMM_BROADCAST_COMPRESS,
                         COMM_BROADCAST_FULL, COMM_COMPRESSION_METHODS)


def topk_compress(vec: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the k largest-magnitude entries: returns (values[k], idx[k])
    in ``jax.lax.top_k``'s order (ties: lower index first)."""
    k = max(min(int(k), vec.shape[0]), 1)
    idx = torch.sort(torch.abs(vec), descending=True, stable=True).indices[:k]
    return vec[idx], idx.to(torch.int32)


# --- wire-efficient cross-silo updates -------------------------------------
#
# QSGD-style stochastic int8 quantization (Alistarh et al., 2017) composed
# with top-k/rand-k sparsification and per-sender error feedback (Lin et
# al., 2018 Deep Gradient Compression; Karimireddy et al., 2019 EF-SGD).
# The WAN managers carry the residual across rounds so biased compressors
# still converge.

#: int8 carries sign * level with level in [0, 127]
QSGD_MAX_LEVELS = 127

#: marker key identifying a compressed-update payload on the wire
WIRE_FLAG = "__cc__"


@dataclass(frozen=True)
class CommCompressionSpec:
    """Parsed ``comm_compression`` config (see ``arguments.py`` knobs).
    ``method=None`` is a broadcast-only spec (bf16 downlink, dense f32
    uplink)."""
    method: Optional[str]       # one of COMM_COMPRESSION_METHODS, or None
    ratio: float = 0.1          # sparsifier keep-ratio (ignored by 'qsgd')
    levels: int = QSGD_MAX_LEVELS   # quantization levels (<= 127 for int8)
    broadcast: str = "full"     # server->client sync: full | bf16 | compress

    def __post_init__(self):
        if self.method is not None \
                and self.method not in COMM_COMPRESSION_METHODS:
            raise ValueError(
                f"unknown comm_compression method {self.method!r} "
                f"(one of {COMM_COMPRESSION_METHODS})")
        if not 0.0 < float(self.ratio) <= 1.0:
            raise ValueError(f"comm_compression_ratio must be in (0, 1], "
                             f"got {self.ratio}")
        if not 1 <= int(self.levels) <= QSGD_MAX_LEVELS:
            raise ValueError(f"comm_quantize_levels must be in [1, "
                             f"{QSGD_MAX_LEVELS}], got {self.levels}")
        if self.broadcast not in (COMM_BROADCAST_FULL, COMM_BROADCAST_BF16,
                                  COMM_BROADCAST_COMPRESS):
            raise ValueError(f"comm_compression_broadcast must be full|"
                             f"bf16|compress, got {self.broadcast!r}")
        if self.method is None and self.broadcast == COMM_BROADCAST_COMPRESS:
            raise ValueError(
                "comm_compression_broadcast=compress needs a compressor: "
                f"set comm_compression (one of {COMM_COMPRESSION_METHODS})")

    @property
    def quantized(self) -> bool:
        return bool(self.method) and self.method.endswith("qsgd")


def spec_from_args(args) -> Optional[CommCompressionSpec]:
    """Build the spec from flat config; None = compression off (the
    default — wire payloads stay byte-identical to the uncompressed
    path)."""
    method = getattr(args, "comm_compression", None)
    if not method or str(method).lower() in ("none", "off", "false", "0"):
        method = None
    # None-checks, not `or`: an explicit 0 must reach the spec validation
    # and be rejected there, not silently become the default
    ratio = getattr(args, "comm_compression_ratio", None)
    levels = getattr(args, "comm_quantize_levels", None)
    broadcast = getattr(args, "comm_compression_broadcast", None)
    broadcast = "full" if broadcast is None else str(broadcast).lower()
    if method is None and broadcast == COMM_BROADCAST_FULL:
        return None
    # a non-full broadcast alone still yields a spec (bf16-only downlink
    # must not be silently ignored; compress-only is rejected in __post_init__)
    return CommCompressionSpec(
        method=None if method is None else str(method).lower(),
        ratio=0.1 if ratio is None else float(ratio),
        levels=QSGD_MAX_LEVELS if levels is None else int(levels),
        broadcast=broadcast)


def qsgd_quantize(vec: torch.Tensor, levels: int, rng: np.ndarray
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic uniform quantization to int8 sign*level: returns
    (q[int8], scale[f32]) with E[dequantize(q, scale)] = vec. The
    rounding is ``floor(|x| / scale * levels + u)``, the multiply-add
    fused (one rounding), ``u = uniform(rng)``."""
    levels = int(levels)
    vec = vec.float()
    n = vec.shape[0]
    scale = (torch.abs(vec).max() if n
             else torch.zeros((), dtype=torch.float32, device=vec.device))
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    u = prng.uniform_t(rng, n, vec.device)
    mag = torch.floor(prng._TorchOps.fma(
        torch.abs(vec) / safe, torch.full_like(u, float(levels)), u))
    q = torch.sign(vec) * torch.clamp(mag, 0, levels)
    return q.to(torch.int8), scale


def _qsgd_dequantize_fused(q: torch.Tensor, scale: torch.Tensor,
                           levels: int) -> torch.Tensor:
    """``q * scale / levels`` as the JAX package's jitted core computes
    it: XLA folds the division by the constant ``levels`` into a multiply
    by its float32 reciprocal."""
    inv = float(np.float32(1.0) / np.float32(int(levels)))
    return q.float() * (scale * inv)


def _ef_compress_core(method: str, d: int, k: int, levels: int,
                      vec: torch.Tensor, residual: torch.Tensor,
                      rng: np.ndarray):
    """(compensate -> sparsify -> quantize -> residual) on ``vec``'s
    device. Returns (values, indices, scale, residual) with indices/scale
    possibly unused depending on the method."""
    comp = vec + residual
    srng, qrng = prng.split(rng)
    dev = comp.device
    if method.startswith("topk"):
        vals, idx = topk_compress(comp, k)
    elif method.startswith("randk"):
        # contractive rand-k (no d/k rescale): error feedback re-injects
        # the dropped mass next round — an unbiased d/k rescale would
        # make the residual grow without bound here
        idx = prng.permutation_t(srng, d, dev)[:k].to(torch.int32)
        vals = comp[idx.long()]
    else:  # pure qsgd: dense quantization
        vals, idx = comp, torch.arange(d, dtype=torch.int32, device=dev)
    if method.endswith("qsgd"):
        q, scale = qsgd_quantize(vals, levels, qrng)
        deq = _qsgd_dequantize_fused(q, scale, levels)
        out_vals = q
    else:
        deq = vals
        scale = torch.zeros((), dtype=torch.float32, device=dev)
        out_vals = vals
    restored = torch.zeros(d, dtype=torch.float32, device=dev)
    restored[idx.long()] = deq
    return out_vals, idx, scale, comp - restored


def ef_compress_vec(vec, residual, spec: CommCompressionSpec,
                    rng: np.ndarray) -> Tuple[Dict[str, Any], np.ndarray]:
    """Compress a flat f32 update with error feedback.

    ``residual`` is the sender's carry-over from previous rounds (None on
    round 0). Returns ``(wire_blob, new_residual)`` — the blob is a
    msgpack-friendly dict of host numpy arrays; the residual must be fed
    back on the next call so compression error is re-injected instead of
    lost (this is what makes biased sparsifiers converge). The compressor
    runs where ``vec`` lies (a host array: the CPU)."""
    if torch.is_tensor(vec):
        vec_t = vec.detach().float().reshape(-1)
    else:
        vec_t = torch.from_numpy(np.array(vec, np.float32).ravel())
    d = int(vec_t.shape[0])
    if residual is None:
        res_t = torch.zeros(d, dtype=torch.float32, device=vec_t.device)
    else:
        res_t = (residual.float() if torch.is_tensor(residual) else
                 torch.from_numpy(np.array(residual, np.float32))
                 ).to(vec_t.device)
    k = max(int(d * float(spec.ratio)), 1) if spec.method != "qsgd" else d
    vals, idx, scale, new_residual = _ef_compress_core(
        spec.method, d, k, int(spec.levels), vec_t, res_t, rng)
    blob: Dict[str, Any] = {WIRE_FLAG: 1, "m": spec.method, "d": d,
                            "v": vals.cpu().numpy()}
    if spec.method != "qsgd":  # dense qsgd needs no index list
        host_idx = idx.cpu().numpy()
        blob["i"] = host_idx.astype(
            np.uint16 if d <= np.iinfo(np.uint16).max else np.int32)
    if spec.quantized:
        blob["s"] = float(scale)
        blob["L"] = int(spec.levels)
    return blob, new_residual.cpu().numpy()


def is_compressed_payload(payload: Any) -> bool:
    return isinstance(payload, dict) and bool(payload.get(WIRE_FLAG))


def decompress_vec(blob: Dict[str, Any]) -> np.ndarray:
    """Inverse of :func:`ef_compress_vec` (host-side, numpy only — the
    receiver need not touch the accelerator to reassemble the update)."""
    d = int(blob["d"])
    vals = np.asarray(blob["v"])
    if "s" in blob:  # quantized values: int8 sign*level -> f32
        vals = vals.astype(np.float32) * (float(blob["s"])
                                          / int(blob["L"]))
    else:
        vals = vals.astype(np.float32)
    if "i" not in blob:
        return vals.astype(np.float32, copy=False)
    out = np.zeros(d, np.float32)
    out[np.asarray(blob["i"]).astype(np.int64)] = vals
    return out
