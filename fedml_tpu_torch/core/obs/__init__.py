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
- :mod:`.sink`: where records go (nowhere until a caller installs one).

Not ported yet: ``roofline`` (``obs_roofline`` raises), ``schema`` and
the mlops plumbing (ROADMAP Queue A item 11).
"""

from __future__ import annotations

from . import flight, metrics, profiler, sink, trace  # noqa: F401
from .flight import FlightRecorder, Watchdog  # noqa: F401
from .metrics import REGISTRY  # noqa: F401
from .trace import (NOOP_SPAN, SpanContext, current_span,  # noqa: F401
                    parse_traceparent, span, tracer)
