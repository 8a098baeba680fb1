"""Adaptive keep-ratio schedules for the wire pipeline (a copy of
``fedml_tpu/core/wire/adaptive.py``).

The ``ClientStatsStore`` tracks per-silo upload latency
(EMA) and a Beta dropout posterior. When ``comm_compression_adaptive``
is on, the server picks the next round's sparsification keep-ratio from
those observations — tighter wire when uplinks run slow or flaky,
looser (more signal per round) when the cohort is healthy — clamped to
``[ratio_min, ratio_max]``. The chosen ratio rides the sync message so
client uplinks and the server decoder agree per round; with the knob
off nothing is added to the wire.

Deterministic: same stats → same ratio (no RNG), so resumed runs pick
identical schedules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

__all__ = ["AdaptiveRatioBounds", "adaptive_keep_ratio"]

# ClientStatsStore's dropout prior is Beta(1, 4) → posterior mean 0.2
# before any observation; pressure is measured as excess over the prior.
_DROP_PRIOR_MEAN = 0.2


@dataclass(frozen=True)
class AdaptiveRatioBounds:
    """Configured bounds for the per-round keep-ratio."""

    ratio_min: float
    ratio_max: float
    latency_budget_s: Optional[float] = None  # uplink latency considered "full pressure"

    def __post_init__(self) -> None:
        if not (0.0 < self.ratio_min <= self.ratio_max <= 1.0):
            raise ValueError(
                f"need 0 < ratio_min <= ratio_max <= 1, got "
                f"[{self.ratio_min}, {self.ratio_max}]")
        if self.latency_budget_s is not None and self.latency_budget_s <= 0:
            raise ValueError("latency_budget_s must be positive")


def adaptive_keep_ratio(bounds: AdaptiveRatioBounds, stats,
                        ranks: Sequence[int]) -> float:
    """Pick the round's keep-ratio from observed upload latency and the
    dropout posterior of ``ranks``.

    Pressure in [0, 1] is the max of two signals: how close the slowest
    observed silo runs to the latency budget, and how far the worst
    dropout posterior sits above its prior. ``ratio = ratio_max -
    (ratio_max - ratio_min) * pressure`` — unobserved cohorts (all-NaN
    latency, prior-only posteriors) get ``ratio_max``.
    """
    ranks = list(ranks)
    if not ranks or stats is None:
        return bounds.ratio_max
    lat_frac = 0.0
    if bounds.latency_budget_s is not None:
        lat = np.asarray(stats.latency_for(ranks), np.float64)
        seen = lat[np.isfinite(lat)]
        if seen.size:
            lat_frac = float(np.clip(
                seen.max() / bounds.latency_budget_s, 0.0, 1.0))
    drop = np.asarray(stats.dropout_posterior_mean(ranks), np.float64)
    drop_frac = float(np.clip(
        (drop.max(initial=0.0) - _DROP_PRIOR_MEAN) / (1.0 - _DROP_PRIOR_MEAN),
        0.0, 1.0))
    pressure = max(lat_frac, drop_frac)
    ratio = bounds.ratio_max - (bounds.ratio_max - bounds.ratio_min) * pressure
    return float(np.clip(ratio, bounds.ratio_min, bounds.ratio_max))
