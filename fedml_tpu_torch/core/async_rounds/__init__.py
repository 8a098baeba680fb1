"""Buffered-async federated rounds (FedBuff + FedAsync staleness decay);
a copy of ``fedml_tpu/core/async_rounds`` (it imports no JAX).

The pieces every async path composes:

* :mod:`.weighting` — staleness -> weight families (constant / polynomial
  / hinge), the pour's (relative mix, absolute merge scale) split, and the
  adaptive staleness cap driven by observed arrival rates.
* :mod:`.buffer` — the staleness-tagged :class:`UpdateBuffer` with
  fixed-shape checkpoint persistence.
* :mod:`.arrivals` — the seeded client-latency model the simulated async
  clock runs on (shared by the SP toy and the GPU engine).

Consumers: ``simulation/gpu/async_engine.py`` (``round_mode:
async_buffered``) and ``simulation/sp/async_fedavg.py``.
"""

from .arrivals import client_durations, durations_from_args, faulted_duration
from .buffer import BufferedUpdate, UpdateBuffer
from .weighting import (MAX_STALENESS_CAP, MIN_STALENESS_CAP,
                        STALENESS_WEIGHTINGS, adaptive_staleness_cap,
                        make_staleness_fn, merge_alpha_from_args,
                        pour_weights, staleness_cap_from_args,
                        staleness_fn_from_args, weighting_knobs_from_args)

ROUND_MODES = ("sync", "async_buffered")


def round_mode_from_args(args) -> str:
    mode = str(getattr(args, "round_mode", "sync") or "sync").lower()
    if mode not in ROUND_MODES:
        raise ValueError(f"round_mode {mode!r} unknown; choose from "
                         f"{ROUND_MODES}")
    return mode


def buffer_k_from_args(args, concurrency: int) -> int:
    """``async_buffer_k`` (0 = half the in-flight cohort, FedBuff's usual
    regime), clamped to the concurrency — a K no cohort can fill would
    deadlock the pour trigger."""
    k = int(getattr(args, "async_buffer_k", 0) or 0)
    if k <= 0:
        k = max(int(concurrency) // 2, 1)
    if k > int(concurrency):
        raise ValueError(
            f"async_buffer_k ({k}) exceeds the in-flight cohort "
            f"({concurrency}): the pour trigger could never fire")
    return k

__all__ = [
    "BufferedUpdate", "UpdateBuffer", "ROUND_MODES",
    "STALENESS_WEIGHTINGS", "MIN_STALENESS_CAP", "MAX_STALENESS_CAP",
    "adaptive_staleness_cap", "buffer_k_from_args", "client_durations",
    "durations_from_args", "faulted_duration", "make_staleness_fn",
    "merge_alpha_from_args", "pour_weights", "round_mode_from_args",
    "staleness_cap_from_args", "staleness_fn_from_args",
    "weighting_knobs_from_args",
]
