"""Distributed tracing — real spans with trace/span IDs, Dapper-style
(counterpart of ``fedml_tpu/core/obs/trace.py``; spans are emitted through
:mod:`.sink`, which ``mlops`` shares).

The plane the old ``mlops.event`` never was: every span carries a
process-unique ``span_id`` inside a run-spanning ``trace_id``, nests under
a parent (thread-local context stack), records point-in-time EVENTS
(backoff retries, chaos link faults), and LINKS to spans in *other*
traces (an async pour links the K upload spans it consumed, staleness
attached per link — the links-not-parents shape is exactly OpenTelemetry's
answer to fan-in). Context crosses the wire as a W3C ``traceparent``
header (``00-<trace_id>-<span_id>-01``) on :class:`Message`, so one
federated round — server broadcast → per-silo train → upload → aggregate —
reconstructs as a single trace tree across processes regardless of
transport (the header is an ordinary message param; TCP, gRPC, and the
pub/sub broker all carry it for free).

Spans are emitted as ``kind: span`` records through the obs sink on
:meth:`Span.end`. Tracing is default-ON (it is cheap:
a span is a dict and one JSONL line; there is no per-op instrumentation)
and disabled with ``obs_tracing: false`` — every entry point then returns
the shared no-op span, so instrumented code never branches.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Any, Dict, List, Optional

# the Message param carrying the W3C context header
TRACEPARENT_KEY = "traceparent"

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")

_cfg = {"enabled": True}


def set_enabled(on: bool) -> None:
    _cfg["enabled"] = bool(on)


def is_enabled() -> bool:
    return _cfg["enabled"]


def _rand_hex(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class SpanContext:
    """The propagatable identity of a span: (trace_id, span_id)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def __repr__(self) -> str:
        return f"SpanContext({self.traceparent()})"


def parse_traceparent(header: Optional[str]) -> Optional[SpanContext]:
    """W3C ``traceparent`` -> :class:`SpanContext`, or None on anything
    malformed (a garbled header degrades to an unparented span, never an
    error — observability must not take down the data path)."""
    if not isinstance(header, str):
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    return SpanContext(m.group(1), m.group(2))


# thread-local active-span stack (the implicit parent for new spans)
_tls = threading.local()


def _stack() -> List["Span"]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_span() -> Optional["Span"]:
    st = _stack()
    return st[-1] if st else None


def add_event(name: str, **attrs: Any) -> None:
    """Attach a point-in-time event to the current span, if any — the
    seam deep layers (backoff retries, chaos faults) use without needing
    a span handle threaded through."""
    sp = current_span()
    if sp is not None:
        sp.add_event(name, **attrs)


class Span:
    """One timed operation. Usable as a context manager (activates on the
    thread-local stack: children started on this thread nest under it) or
    as a bare handle (``start_span`` + ``end()``)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_ts",
                 "end_ts", "attrs", "events", "links", "_lock", "_active")

    def __init__(self, name: str, trace_id: str, parent_id: Optional[str],
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = str(name)
        self.trace_id = trace_id
        self.span_id = _rand_hex(8)
        self.parent_id = parent_id
        self.start_ts = time.time()
        self.end_ts: Optional[float] = None
        self.attrs: Dict[str, Any] = dict(attrs or {})
        self.events: List[Dict[str, Any]] = []
        self.links: List[Dict[str, Any]] = []
        # events/links can arrive from other threads (upload handlers
        # annotate the server's wait span); end() is guarded idempotent
        self._lock = threading.Lock()
        self._active = False

    # --- identity -----------------------------------------------------------
    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def traceparent(self) -> str:
        return self.context.traceparent()

    # --- enrichment ---------------------------------------------------------
    def set_attr(self, key: str, value: Any) -> "Span":
        with self._lock:
            self.attrs[str(key)] = value
        return self

    def add_event(self, name: str, **attrs: Any) -> "Span":
        with self._lock:
            self.events.append({"name": str(name), "ts": time.time(),
                                **({"attrs": attrs} if attrs else {})})
        return self

    def add_link(self, ctx: Any, **attrs: Any) -> "Span":
        """Link another span (a :class:`SpanContext`, a :class:`Span`, or
        a raw traceparent string) — possibly from a different trace; the
        fan-in edge a parent/child tree cannot express."""
        if isinstance(ctx, Span):
            ctx = ctx.context
        elif isinstance(ctx, str):
            ctx = parse_traceparent(ctx)
        if ctx is None:
            return self
        with self._lock:
            self.links.append({"trace_id": ctx.trace_id,
                               "span_id": ctx.span_id,
                               **({"attrs": attrs} if attrs else {})})
        return self

    # --- lifecycle ----------------------------------------------------------
    def end(self) -> Optional[float]:
        """Close the span and emit its record. Idempotent; returns the
        duration in seconds (None if already ended elsewhere)."""
        with self._lock:
            if self.end_ts is not None:
                return None
            self.end_ts = time.time()
            rec = {"name": self.name, "trace_id": self.trace_id,
                   "span_id": self.span_id, "parent_id": self.parent_id,
                   "start_ts": self.start_ts, "end_ts": self.end_ts,
                   "duration_s": self.end_ts - self.start_ts,
                   "pid": os.getpid()}
            if self.attrs:
                rec["attrs"] = dict(self.attrs)
            if self.events:
                rec["events"] = list(self.events)
            if self.links:
                rec["links"] = list(self.links)
        _emit_span(rec)
        return rec["duration_s"]

    @property
    def duration_s(self) -> Optional[float]:
        return None if self.end_ts is None else self.end_ts - self.start_ts

    def __enter__(self) -> "Span":
        self._active = True
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> bool:
        st = _stack()
        if self._active and self in st:
            # remove THIS span even if a child leaked (mis-nesting must
            # not shift which span later code annotates)
            st.remove(self)
        self._active = False
        if exc and exc[0] is not None:
            self.set_attr("error", getattr(exc[0], "__name__", str(exc[0])))
        self.end()
        return False


class _NoopSpan:
    """Shared inert span: every mutator no-ops, context is None — the
    instrumented call sites never branch on the tracing knob."""

    context = None
    duration_s = None
    name = trace_id = span_id = parent_id = None

    def traceparent(self):
        return None

    def set_attr(self, key, value):
        return self

    def add_event(self, name, **attrs):
        return self

    def add_link(self, ctx, **attrs):
        return self

    def end(self):
        return None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Span factory. One module-level instance (:data:`tracer`) — a
    process is one rank, exactly like ``WIRE_STATS``."""

    def start_span(self, name: str, parent: Any = None, root: bool = False,
                   attrs: Optional[Dict[str, Any]] = None):
        """Create a span (not yet on the context stack — use it as a
        context manager to activate it, or keep it as a bare handle).

        ``parent`` may be a Span, a SpanContext, a traceparent string, or
        None (inherit the thread's current span). ``root=True`` forces a
        fresh trace even when a span is active — round/pour boundaries."""
        if not _cfg["enabled"]:
            return NOOP_SPAN
        if isinstance(parent, str):
            parent = parse_traceparent(parent)
        if isinstance(parent, Span):
            parent = parent.context
        if parent is not None and getattr(parent, "trace_id", None) is None:
            # a _NoopSpan handle (stored while tracing was off) or a
            # degenerate context: treat as no parent rather than minting
            # a span with trace_id=None that violates the schema
            parent = None
        if parent is None and not root:
            cur = current_span()
            if cur is not None:
                parent = cur.context
        if root:
            parent = None
        if parent is not None:
            return Span(name, parent.trace_id, parent.span_id, attrs)
        return Span(name, _rand_hex(16), None, attrs)

    # context-manager spelling reads better at call sites
    span = start_span


tracer = Tracer()


def span(name: str, parent: Any = None, root: bool = False,
         attrs: Optional[Dict[str, Any]] = None):
    """Module-level shortcut: ``with obs_trace.span("broadcast"): ...``"""
    return tracer.start_span(name, parent=parent, root=root, attrs=attrs)


# --- Message propagation ----------------------------------------------------

def inject(msg, span_or_ctx: Any = None) -> None:
    """Stamp the current (or given) span's traceparent onto an outgoing
    :class:`Message` — the ONE seam every transport inherits, because the
    header is an ordinary message param."""
    if not _cfg["enabled"]:
        return
    sp = span_or_ctx if span_or_ctx is not None else current_span()
    if isinstance(sp, Span):
        sp = sp.context
    if isinstance(sp, SpanContext):
        msg.add_params(TRACEPARENT_KEY, sp.traceparent())


def extract(msg) -> Optional[SpanContext]:
    """Read the remote trace context off a received :class:`Message`."""
    return parse_traceparent(msg.get(TRACEPARENT_KEY))


# --- emission ---------------------------------------------------------------

def _emit_span(rec: Dict[str, Any]) -> None:
    from . import sink
    sink.emit("span", rec)
