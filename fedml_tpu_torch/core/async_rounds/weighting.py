"""Staleness weighting — the ONE definition shared by every async path (a
copy of ``fedml_tpu/core/async_rounds/weighting.py``).

Buffered-async aggregation (FedBuff, Nguyen et al., AISTATS 2022) pours a
buffer of K client updates whenever they arrive, each down-weighted by how
many model versions elapsed since the client was handed its base model.
FedAsync (Xie et al., 2019) supplies the decay families implemented here:

* ``constant`` — ``s(t) = 1``: pure FedBuff, arrival order alone decides.
* ``polynomial`` — ``s(t) = (1 + t)^(-a)``: smooth decay, the default (and
  what the SP ``async_fedavg`` toy always used).
* ``hinge`` — ``s(t) = 1`` for ``t <= b``, else ``1 / (a * (t - b) + 1)``:
  free staleness up to ``b`` versions, hyperbolic decay past it.

Staleness is CLAMPED to ``cap`` before weighting — a stale upload is
down-weighted, never dropped (the cap saturates the decay so one
long-partitioned silo's redemption update still moves the model). All
functions are plain NumPy/host math so they are unit-testable without a
device and usable both host-side (SP toy) and as DATA on the device
(the GPU engine computes weights host-side and feeds them to the
pour as a ``[K]`` tensor — weighting never recompiles anything).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

STALENESS_WEIGHTINGS = ("constant", "polynomial", "hinge")

# staleness caps must stay in a sane band: 1 keeps only fresh-or-one-late
# updates at full decay resolution, 1024 is "effectively uncapped" while
# still bounding a base ring
MIN_STALENESS_CAP = 1
MAX_STALENESS_CAP = 1024


def make_staleness_fn(kind: str = "polynomial", poly_a: float = 0.5,
                      hinge_b: int = 4, cap: int = 16
                      ) -> Callable[[np.ndarray], np.ndarray]:
    """Vectorized staleness -> weight in ``(0, 1]``. ``cap`` clamps the
    input staleness (down-weight saturates; updates are never zeroed)."""
    kind = str(kind or "polynomial").lower()
    if kind not in STALENESS_WEIGHTINGS:
        raise ValueError(f"async_staleness_weighting {kind!r} unknown; "
                         f"choose from {STALENESS_WEIGHTINGS}")
    a = float(poly_a)
    if a < 0.0:
        raise ValueError("async_staleness_poly must be >= 0")
    b = max(int(hinge_b), 0)
    cap = int(np.clip(int(cap), MIN_STALENESS_CAP, MAX_STALENESS_CAP))

    def fn(staleness) -> np.ndarray:
        s = np.clip(np.asarray(staleness, np.float64), 0.0, float(cap))
        if kind == "constant":
            w = np.ones_like(s)
        elif kind == "polynomial":
            w = (1.0 + s) ** (-a)
        else:  # hinge (np.where evaluates both branches: clamp the
            # denominator so s <= b entries can't divide by <= 0)
            w = np.where(s <= b, 1.0,
                         1.0 / np.maximum(a * (s - b) + 1.0, 1e-9))
        return np.asarray(w, np.float32)

    return fn


def _num_knob(args, name: str, default: float) -> float:
    """Numeric knob with an EXPLICIT absence check: 0 is a legitimate
    value for most async knobs (poly_a=0 = no decay, alpha=0 = frozen
    control, hinge_b=0 = decay from the first stale version), so the
    usual ``or default`` idiom would silently revert it."""
    v = getattr(args, name, None)
    return float(default if v is None else v)


def weighting_knobs_from_args(args):
    """(kind, poly_a, hinge_b) — the one reading shared by every async
    surface (engine, SP toy), including the adaptive
    staleness-cap rebuilds."""
    kind = str(getattr(args, "async_staleness_weighting", None)
               or "polynomial").lower()
    return (kind, _num_knob(args, "async_staleness_poly", 0.5),
            int(_num_knob(args, "async_hinge_b", 4)))


def staleness_fn_from_args(args) -> Callable[[np.ndarray], np.ndarray]:
    """The ``async_staleness_*`` knobs, read once (see arguments.py)."""
    kind, poly_a, hinge_b = weighting_knobs_from_args(args)
    return make_staleness_fn(kind=kind, poly_a=poly_a, hinge_b=hinge_b,
                             cap=staleness_cap_from_args(args))


def staleness_cap_from_args(args) -> int:
    """Static staleness cap; ``async_staleness_cap: 0`` means adaptive
    (:func:`adaptive_staleness_cap` re-derives it each pour) — callers
    still need a concrete starting value, which is the default 16."""
    cap = int(getattr(args, "async_staleness_cap", 16) or 0)
    return int(np.clip(cap if cap > 0 else 16,
                       MIN_STALENESS_CAP, MAX_STALENESS_CAP))


def merge_alpha_from_args(args) -> float:
    """The FedAsync mixing rate: the poured aggregate is applied scaled by
    ``alpha * (sample-weighted mean staleness weight)``. 0 is honored (a
    frozen-server control config), absent means the 0.6 default."""
    return _num_knob(args, "async_alpha", 0.6)


def pour_weights(weights, staleness, fn: Callable[[np.ndarray], np.ndarray],
                 alpha: float) -> Tuple[np.ndarray, float]:
    """Combine per-update sample weights with staleness decay.

    Returns ``(norm_w [K], merge_scale)``: ``norm_w`` sums to 1 (the
    relative mix WITHIN the pour — staler updates count for less against
    their peers), ``merge_scale = alpha * Σ(w·s)/Σ(w)`` is the absolute
    damping of the applied aggregate (an all-fresh pour applies
    ``alpha · Δ``, an all-stale pour a proportionally smaller step). The
    split matters: folding staleness only into the relative mix would let
    a pour of uniformly ancient updates move the model at full rate."""
    w = np.asarray(weights, np.float64)
    s = np.asarray(fn(staleness), np.float64)
    cw = w * s
    denom = max(float(np.sum(cw)), 1e-12)
    norm_w = np.asarray(cw / denom, np.float32)
    merge_scale = float(alpha) * float(np.sum(cw)) / max(float(np.sum(w)),
                                                         1e-12)
    return norm_w, merge_scale


def adaptive_staleness_cap(latencies_s, pour_interval_s: float,
                           lo: int = 2, hi: int = 64) -> int:
    """Derive the staleness cap from OBSERVED arrival behavior
    (``async_staleness_cap: 0``): the slowest client's latency divided by
    the mean pour interval is how many versions its uploads lag — cap a
    bit above that so routine stragglers keep full decay resolution while
    a wedged client's eventual redemption still saturates. Fed by the
    selection store's arrival-rate posteriors on the GPU engine."""
    lat = np.asarray(latencies_s, np.float64)
    lat = lat[np.isfinite(lat) & (lat > 0.0)]
    if lat.size == 0 or not np.isfinite(pour_interval_s) \
            or pour_interval_s <= 0.0:
        return int(hi)
    worst = float(np.max(lat))
    cap = int(np.ceil(worst / pour_interval_s)) + 1
    return int(np.clip(cap, lo, hi))
