"""Observability planes (counterpart of ``fedml_tpu/core/obs/``, ported
as far as the serving engine, its scheduler and the GPU engine use it):

- :mod:`.trace`: spans with trace/span IDs and W3C ``traceparent``
  parsing (one trace per request);
- :mod:`.metrics`: counter/gauge/histogram registry with Prometheus
  exposition, the ``record_llm_*`` hooks and :class:`LatencyWindow`;
- :mod:`.flight`: the black-box :class:`FlightRecorder` and the stall /
  NaN :class:`Watchdog`;
- :mod:`.profiler`: the dispatch seam's host/device split, the peak
  table and MFU (``obs_profile_device``);
- :mod:`.sink`: where records go (the run's JSONL file once
  ``core/mlops.init`` opens it, and a caller's callable);
- :mod:`.schema`: the one table every record kind validates against (a
  copy of the JAX package's);
- :mod:`.roofline`: the compute plane, per-op roofline records of the
  programs the engines and the serving scheduler dispatch
  (``obs_roofline``) and always-on recompile forensics.

:func:`configure` wires the ``obs_*`` knobs (``core/mlops.init``, which
``fedml_tpu_torch.init`` calls, and ``run_federated_llm`` call it).
"""

from __future__ import annotations

from . import (flight, metrics, profiler, roofline,  # noqa: F401
               schema, sink, trace)
from .flight import FlightRecorder, Watchdog  # noqa: F401
from .metrics import REGISTRY  # noqa: F401
from .trace import (NOOP_SPAN, SpanContext, add_event,  # noqa: F401
                    current_span, extract, inject, parse_traceparent, span,
                    tracer)


def configure(args=None) -> None:
    """Wire the obs knobs from the flat config (idempotent): spans
    (``obs_tracing``), the metrics hooks (``obs_metrics``) and the
    snapshot cadence in rounds and in wall seconds
    (``obs_metrics_flush_rounds``, ``obs_metrics_flush_s``).
    ``args=None`` restores the defaults. ``obs_roofline`` sets the
    roofline capture's process default (the serving scheduler reads it;
    the engines read their own args first). ``obs_profile_device`` is
    read by the engine from its args."""
    trace.set_enabled(bool(getattr(args, "obs_tracing", True)))
    metrics.set_enabled(bool(getattr(args, "obs_metrics", True)))
    metrics.set_flush_every(
        int(getattr(args, "obs_metrics_flush_rounds", 10) or 0))
    metrics.set_flush_interval(
        float(getattr(args, "obs_metrics_flush_s", 60.0) or 0.0))
    roofline.set_default_enabled(bool(getattr(args, "obs_roofline", False)))
