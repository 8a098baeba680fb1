"""Typed metrics registry — counters, gauges, fixed-bucket histograms
(counterpart of ``fedml_tpu/core/obs/metrics.py``, as far as the serving
path, the engine's profiling plane, the wire codec and the round
checkpoints use it: the registry, the ``record_llm_*`` hooks, the watchdog
counter, ``record_round_mfu`` / ``record_hbm_peak``, ``record_wire`` /
``record_wire_stage``, ``record_checkpoint_flush``, the selection hooks
``record_selection`` / ``record_cohort_assembly``, the async engine's
``record_pour`` / ``record_arrival``, the serving fleet's
``record_gateway_route`` / ``_failover`` / ``_heal`` / ``_latency`` and
``record_fleet_scale``, the fleet plane's ``record_fleet_round``,
the compute plane's ``record_roofline`` / ``record_recompile``,
:class:`LatencyWindow`, the
snapshot cadences :func:`maybe_flush` / :func:`set_flush_interval` and
:func:`flush_final`).

Two readouts:

* :func:`exposition` — Prometheus text format (the de-facto wire format
  for pull-based scrapers; also what a human pastes into a bug report);
* ``kind: metrics_snapshot`` records through the obs sink
  (:mod:`.sink`; nothing is written until a caller installs one).

Instruments are get-or-create by name (re-registration with a different
type raises — a name means one thing). Histogram buckets are FIXED at
registration: snapshots from different processes/rounds merge by simple
addition, and the hot-path observe is a bisect, not an allocation.

Default-on (``obs_metrics: true``): the hot hooks are a dict lookup and a
float add. The registry itself always works — only the convenience
``record_*`` hooks consult the knob, so instrumented code never branches.
"""

from __future__ import annotations

import bisect
import collections
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

_cfg = {"enabled": True, "flush_every": 10}


def set_enabled(on: bool) -> None:
    _cfg["enabled"] = bool(on)


def is_enabled() -> bool:
    return _cfg["enabled"]


def set_flush_every(rounds: int) -> None:
    """Snapshot cadence of :func:`maybe_flush` in rounds (0 = never).
    Also resets the per-round dedup, so a new run's round 0 flushes even
    when an earlier run in this process flushed at round 0."""
    _cfg["flush_every"] = max(int(rounds), 0)
    _flush_state["last"] = None


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._data: Dict[Tuple[str, ...], Any] = {}

    def _key(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.label_names)}")
        return tuple(str(labels[k]) for k in self.label_names)

    def _label_str(self, key: Tuple[str, ...]) -> str:
        if not self.label_names:
            return ""
        pairs = ",".join(f'{n}="{v}"'
                         for n, v in zip(self.label_names, key))
        return "{" + pairs + "}"


# process-wide mutation epoch: every instrument write bumps it, so the
# wall-clock flusher can skip snapshots when nothing changed (an idle
# process stays silent instead of re-emitting identical instruments;
# flushed starts EQUAL to epoch so a process that never records
# anything never emits an empty snapshot)
_activity = {"epoch": 0, "flushed": 0}


class Counter(_Instrument):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels: Any) -> None:
        if value < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labels)
        with self._lock:
            self._data[key] = self._data.get(key, 0.0) + float(value)
        _activity["epoch"] += 1

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._data.get(self._key(labels), 0.0))

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{"labels": dict(zip(self.label_names, k)), "value": v}
                    for k, v in sorted(self._data.items())]

    def expose(self) -> List[str]:
        # same lock as snapshot: a transport thread inserting a new
        # label key mid-exposition would otherwise crash the iteration
        with self._lock:
            items = sorted(self._data.items())
        return [f"{self.name}{self._label_str(k)} {v}" for k, v in items]


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._data[key] = float(value)
        _activity["epoch"] += 1

    def inc(self, value: float = 1.0, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._data[key] = self._data.get(key, 0.0) + float(value)
        _activity["epoch"] += 1

    def value(self, **labels: Any) -> Optional[float]:
        with self._lock:
            v = self._data.get(self._key(labels))
            return None if v is None else float(v)

    snapshot = Counter.snapshot
    expose = Counter.expose


class Histogram(_Instrument):
    """Fixed upper-bound buckets (+Inf implied). Per label set:
    cumulative bucket counts, sum, count — the Prometheus layout."""

    kind = "histogram"

    def __init__(self, name: str, help: str, label_names: Tuple[str, ...],
                 buckets: Sequence[float]):
        super().__init__(name, help, label_names)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"{name}: histogram needs >= 1 bucket bound")
        self.buckets = bs

    def observe(self, value: float, **labels: Any) -> None:
        key = self._key(labels)
        value = float(value)
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            ent = self._data.get(key)
            if ent is None:
                ent = self._data[key] = {
                    "counts": [0] * (len(self.buckets) + 1),
                    "sum": 0.0, "count": 0}
            ent["counts"][i] += 1
            ent["sum"] += value
            ent["count"] += 1
        _activity["epoch"] += 1

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            out = []
            for k, ent in sorted(self._data.items()):
                out.append({"labels": dict(zip(self.label_names, k)),
                            "buckets": list(self.buckets),
                            "counts": list(ent["counts"]),
                            "sum": ent["sum"], "count": ent["count"]})
            return out

    def expose(self) -> List[str]:
        lines = []
        with self._lock:  # see Counter.expose
            items = [(k, {"counts": list(e["counts"]), "sum": e["sum"],
                          "count": e["count"]})
                     for k, e in sorted(self._data.items())]
        for k, ent in items:
            cum = 0
            for b, c in zip(self.buckets, ent["counts"]):
                cum += c
                le = self._le_labels(k, b)
                lines.append(f"{self.name}_bucket{le} {cum}")
            le = self._le_labels(k, "+Inf")
            lines.append(f"{self.name}_bucket{le} {ent['count']}")
            ls = self._label_str(k)
            lines.append(f"{self.name}_sum{ls} {ent['sum']}")
            lines.append(f"{self.name}_count{ls} {ent['count']}")
        return lines

    def _le_labels(self, key: Tuple[str, ...], bound) -> str:
        pairs = [f'{n}="{v}"' for n, v in zip(self.label_names, key)]
        pairs.append(f'le="{bound}"')
        return "{" + ",".join(pairs) + "}"


class MetricsRegistry:
    """Get-or-create instrument registry; the process-wide instance is
    :data:`REGISTRY` (one process = one rank, like ``WIRE_STATS``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}

    def _get(self, cls, name: str, help: str, labels: Tuple[str, ...],
             **kw) -> _Instrument:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, help,
                                                     tuple(labels), **kw)
                return inst
        if not isinstance(inst, cls):
            raise ValueError(f"{name} already registered as {inst.kind}")
        if tuple(labels) != inst.label_names:
            raise ValueError(
                f"{name} already registered with labels "
                f"{inst.label_names}, not {tuple(labels)}")
        want_buckets = kw.get("buckets")
        if (want_buckets is not None
                and tuple(sorted(float(b) for b in want_buckets))
                != getattr(inst, "buckets", ())):
            raise ValueError(
                f"{name} already registered with buckets "
                f"{inst.buckets}, not {tuple(want_buckets)}")
        return inst

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, tuple(labels))

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, tuple(labels))

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  labels: Sequence[str] = ()) -> Histogram:
        """``buckets=None`` means "whatever is registered" on a re-get
        (the default bounds apply only on first creation); passing
        explicit buckets that differ from the registered ones raises —
        the observations would land in bounds the caller never asked
        for, silently."""
        if buckets is None and name not in self._instruments:
            buckets = (0.01, 0.1, 1.0, 10.0)
        if buckets is None:
            return self._get(Histogram, name, help, tuple(labels))
        return self._get(Histogram, name, help, tuple(labels),
                         buckets=buckets)

    # --- readouts -----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            insts = list(self._instruments.values())
        return {i.name: {"type": i.kind, "help": i.help,
                         "values": i.snapshot()} for i in insts}

    def exposition(self) -> str:
        """Prometheus text exposition of every instrument."""
        with self._lock:
            insts = sorted(self._instruments.values(), key=lambda i: i.name)
        lines: List[str] = []
        for i in insts:
            if i.help:
                lines.append(f"# HELP {i.name} {i.help}")
            lines.append(f"# TYPE {i.name} {i.kind}")
            lines.extend(i.expose())
        return "\n".join(lines) + ("\n" if lines else "")

    def flush(self, step: Optional[int] = None) -> None:
        """Emit one ``metrics_snapshot`` record through the obs sink."""
        from . import sink
        _activity["flushed"] = _activity["epoch"]
        sink.emit("metrics_snapshot", {"metrics": self.snapshot(),
                                       "step": step})

    def reset(self) -> None:
        """Drop every instrument (tests only — production counters are
        process-lifetime by design)."""
        with self._lock:
            self._instruments.clear()


REGISTRY = MetricsRegistry()

# shared bucket ladders (fixed at registration; see module docstring)
STALENESS_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)
OCCUPANCY_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
WALL_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0)
LATENCY_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0, 300.0)


# --- canonical hooks --------------------------------------------------------
# One helper per seam, so the instrumented code is a single line and the
# metric names/labels cannot drift between callers. Each consults the
# enable knob; the registry itself is always live for direct users.


def record_llm_serving_step(tokens_out: int, occupancy: int,
                            queue_depth: int, tokens_per_s: float) -> None:
    """Continuous-batching decode seam (serving/batch): per-step slot
    occupancy + queue depth histograms and the decode-throughput gauge."""
    if not _cfg["enabled"]:
        return
    REGISTRY.gauge("llm_tokens_per_s",
                   "decode throughput over the engine's rolling window "
                   "(generated tokens/sec)").set(float(tokens_per_s))
    REGISTRY.histogram("llm_slot_occupancy",
                       "in-flight requests per decode step",
                       buckets=OCCUPANCY_BUCKETS).observe(int(occupancy))
    REGISTRY.histogram("llm_queue_depth",
                       "requests waiting for a slot at each decode step",
                       buckets=OCCUPANCY_BUCKETS).observe(int(queue_depth))
    REGISTRY.counter("llm_tokens_generated_total",
                     "tokens emitted by the batched decode "
                     "step").inc(int(tokens_out))


def record_llm_admit(n: int = 1) -> None:
    if not _cfg["enabled"]:
        return
    REGISTRY.counter("llm_requests_admitted_total",
                     "requests admitted into decode slots").inc(int(n))


def record_llm_evict(reason: str) -> None:
    """Eviction seam: deadline evictions vs queued-request expiry."""
    if not _cfg["enabled"]:
        return
    REGISTRY.counter("llm_requests_evicted_total",
                     "requests evicted before natural finish",
                     labels=("reason",)).inc(1, reason=str(reason))


# serving-plane SLO buckets: TTFT is gated by queue wait + prefill (tens
# of ms to seconds); ITL is one decode step (sub-ms to tens of ms)
TTFT_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0)
ITL_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0)
TOKRATE_BUCKETS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                   1000.0)


def record_llm_ttft(seconds: float) -> None:
    """Time-to-first-token: request submit → first generated token (the
    Orca-style admission SLO — queue wait + chunked prefill)."""
    if not _cfg["enabled"]:
        return
    REGISTRY.histogram("llm_ttft_seconds",
                       "request submit to first generated token",
                       buckets=TTFT_BUCKETS).observe(float(seconds))


def record_llm_itl(step_wall_s: float) -> None:
    """Inter-token latency: one observation per decode STEP (every active
    slot experienced this gap — per-step, not per-token, so the hot loop
    costs one bisect regardless of occupancy)."""
    if not _cfg["enabled"]:
        return
    REGISTRY.histogram("llm_inter_token_seconds",
                       "decode-step wall time = inter-token latency of "
                       "every in-flight request",
                       buckets=ITL_BUCKETS).observe(float(step_wall_s))


def record_llm_request(tokens_per_s: float, queue_wait_s: float) -> None:
    """Per-request close-out: individual decode throughput + queue wait
    (the aggregate tokens/s gauge hides per-request starvation)."""
    if not _cfg["enabled"]:
        return
    REGISTRY.histogram("llm_request_tokens_per_s",
                       "per-request decode throughput at finish",
                       buckets=TOKRATE_BUCKETS).observe(
                           float(tokens_per_s))
    REGISTRY.histogram("llm_queue_wait_seconds",
                       "request submit to decode-slot admission",
                       buckets=TTFT_BUCKETS).observe(float(queue_wait_s))


def record_llm_kv_pool(used_blocks: int, free_blocks: int,
                       headroom_requests: int, fragmentation: float,
                       aliased_blocks: Optional[int] = None,
                       cached_blocks: Optional[int] = None) -> None:
    """Paged-KV pool state: occupancy, free list, how many WORST-CASE
    requests the admission reserve could still take, internal
    fragmentation (reserved-but-unwritten fraction of allocated
    blocks), and — with the shared-prefix cache on — how many blocks
    are currently shared (refcount >= 2) or held warm by the index."""
    if not _cfg["enabled"]:
        return
    REGISTRY.gauge("llm_kv_blocks_used",
                   "KV pool blocks allocated to slots").set(
                       int(used_blocks))
    REGISTRY.gauge("llm_kv_blocks_free",
                   "KV pool blocks on the free list").set(int(free_blocks))
    REGISTRY.gauge("llm_kv_admission_headroom_requests",
                   "worst-case (max_seq_len) requests the free list can "
                   "still admit").set(int(headroom_requests))
    REGISTRY.gauge("llm_kv_fragmentation",
                   "reserved-but-unwritten fraction of allocated KV "
                   "blocks").set(float(fragmentation))
    if aliased_blocks is not None:
        REGISTRY.gauge("llm_kv_aliased_blocks",
                       "physical KV blocks shared by more than one "
                       "reference (prefix aliasing)").set(
                           int(aliased_blocks))
    if cached_blocks is not None:
        REGISTRY.gauge("llm_kv_cached_blocks",
                       "KV blocks pinned warm by the prefix index").set(
                           int(cached_blocks))


def record_llm_prefix_cache(cached_tokens: int, novel_tokens: int) -> None:
    """Prefix-cache admission outcome: tokens reused from resident
    blocks vs tokens actually prefilled. The hit-rate the bench gates is
    ``cached_total / (cached_total + prefilled_total)``."""
    if not _cfg["enabled"]:
        return
    c = REGISTRY.counter("llm_prefix_lookups_total",
                         "prefix-cache lookups at admission",
                         labels=("outcome",))
    c.inc(1, outcome="hit" if cached_tokens > 0 else "miss")
    REGISTRY.counter("llm_prefix_cached_tokens_total",
                     "prompt tokens served from cached KV blocks "
                     "(never prefilled)").inc(int(cached_tokens))
    REGISTRY.counter("llm_prefix_prefilled_tokens_total",
                     "prompt tokens actually prefilled").inc(
                         int(novel_tokens))


def record_llm_suffix_cache(reused_tokens: int) -> None:
    """Suffix-cache admission outcome: generated (decode-origin) tokens
    a follow-up/requeued request aliased instead of re-prefilling."""
    if not _cfg["enabled"]:
        return
    REGISTRY.counter("llm_suffix_hits_total",
                     "admissions that aliased generated-token "
                     "(decode-origin) cached blocks").inc(1)
    REGISTRY.counter("llm_suffix_reused_tokens_total",
                     "generated tokens served from cached KV blocks "
                     "(never re-prefilled)").inc(int(reused_tokens))


def record_llm_suffix_insert(blocks: int) -> None:
    """Decode blocks indexed into the prefix cache at slot release."""
    if not _cfg["enabled"] or not blocks:
        return
    REGISTRY.counter("llm_suffix_inserted_blocks_total",
                     "generated-token KV blocks indexed at release").inc(
                         int(blocks))


def record_llm_prefix_evictions(n: int) -> None:
    """Cached prefix blocks evicted under KV pool pressure."""
    if not _cfg["enabled"] or not n:
        return
    REGISTRY.counter("llm_prefix_evictions_total",
                     "prefix-cache entries evicted for admission "
                     "headroom").inc(int(n))


def record_llm_prefill_wave(wave_size: int) -> None:
    """One piggybacked-prefill admission wave of ``wave_size`` requests
    (1 = a serial admission)."""
    if not _cfg["enabled"]:
        return
    REGISTRY.histogram("llm_prefill_wave_requests",
                       "admissions batched into one prefill wave",
                       buckets=OCCUPANCY_BUCKETS).observe(int(wave_size))


def record_llm_stream_request() -> None:
    """One request served as an SSE token stream."""
    if not _cfg["enabled"]:
        return
    REGISTRY.counter("llm_stream_requests_total",
                     "requests served as SSE token streams").inc(1)


def record_llm_adapter_swap(name: str) -> None:
    """Adapter hot-swap: a watched export went live as a bank row write
    (zero restart)."""
    if not _cfg["enabled"]:
        return
    REGISTRY.counter("llm_adapter_swaps_total",
                     "adapter-bank hot-swaps from the watched export "
                     "dir", labels=("adapter",)).inc(1, adapter=str(name))


def record_llm_adapter(name: str) -> None:
    """Adapter-bank mix: which personalization each request selected."""
    if not _cfg["enabled"]:
        return
    REGISTRY.counter("llm_adapter_requests_total",
                     "requests by selected adapter",
                     labels=("adapter",)).inc(1, adapter=str(name))


def record_llm_reject(reason: str) -> None:
    """Submit-time rejections (never admitted), by reason — distinct from
    evictions, which had a slot and lost it."""
    if not _cfg["enabled"]:
        return
    REGISTRY.counter("llm_requests_rejected_total",
                     "requests rejected at submit",
                     labels=("reason",)).inc(1, reason=str(reason))


def record_llm_reset(reason: str) -> None:
    """One watchdog-driven engine reset (crash-only recovery): the slot
    matrix + KV pool were rebuilt and the in-flight snapshots requeued."""
    if not _cfg["enabled"]:
        return
    REGISTRY.counter("llm_engine_resets_total",
                     "controlled engine resets (watchdog-driven "
                     "recovery)", labels=("reason",)).inc(
                         1, reason=str(reason))


def record_llm_requeue(reason: str, n: int = 1) -> None:
    """Requests snapshotted and requeued for recompute-from-prompt —
    by an engine reset or a preempt-under-pressure decision."""
    if not _cfg["enabled"]:
        return
    REGISTRY.counter("llm_requests_requeued_total",
                     "in-flight requests requeued for recompute",
                     labels=("reason",)).inc(int(n), reason=str(reason))


def record_watchdog_trip(component: str, reason: str) -> None:
    if not _cfg["enabled"]:
        return
    REGISTRY.counter("obs_watchdog_trips_total",
                     "black-box watchdog trips",
                     labels=("component", "reason")).inc(
                         1, component=str(component), reason=str(reason))


def record_gateway_latency(latency_s: float) -> None:
    """Serving gateway seam: per-request end-to-end latency histogram
    (the exact p50/p99 the autoscaler reads comes from the gateway's
    :class:`LatencyWindow`; this is the exposition/post-mortem view)."""
    if not _cfg["enabled"]:
        return
    REGISTRY.histogram("serving_gateway_latency_seconds",
                       "gateway request latency",
                       buckets=LATENCY_BUCKETS).observe(float(latency_s))


def record_gateway_failover(reason: str) -> None:
    """Gateway routed a request away from a replica (dead connect,
    503-shedding replica, failed health probe)."""
    if not _cfg["enabled"]:
        return
    REGISTRY.counter("serving_gateway_failovers_total",
                     "requests re-routed off a failed/unhealthy replica",
                     labels=("reason",)).inc(1, reason=str(reason))


def record_gateway_route(outcome: str) -> None:
    """Cache-aware routing decision: ``warm_hit`` (digest stuck to its
    warm replica), ``warm_spill`` (warm replica saturated — spilled to
    round-robin without rehoming), ``cold`` (first sight of the digest,
    round-robin pick recorded as the digest's home)."""
    if not _cfg["enabled"]:
        return
    REGISTRY.counter("serving_gateway_routes_total",
                     "cache-aware routing decisions by outcome",
                     labels=("outcome",)).inc(1, outcome=str(outcome))


def record_gateway_heal(port: int) -> None:
    """A quarantined replica passed its recovery probe and rejoined the
    rotation."""
    if not _cfg["enabled"]:
        return
    REGISTRY.counter("serving_gateway_heals_total",
                     "quarantined replicas healed back into "
                     "rotation").inc(1)


def record_fleet_scale(direction: str, replicas: int) -> None:
    """One SLO-driven autoscaler move (``up`` / ``down``) landing on
    ``replicas`` replicas."""
    if not _cfg["enabled"]:
        return
    REGISTRY.counter("serving_fleet_scale_events_total",
                     "autoscaler replica-count changes",
                     labels=("direction",)).inc(1, direction=str(direction))
    REGISTRY.gauge("serving_fleet_replicas",
                   "current serving replica count").set(int(replicas))


def record_wire(msg_type: Any, nbytes: int) -> None:
    """``Message.encode`` seam: per-message-type bytes on the wire."""
    if not _cfg["enabled"]:
        return
    t = str(msg_type)
    REGISTRY.counter("fed_wire_bytes_total",
                     "bytes serialized at Message.encode, by message type",
                     labels=("msg_type",)).inc(int(nbytes), msg_type=t)
    REGISTRY.counter("fed_wire_messages_total",
                     "messages serialized at Message.encode",
                     labels=("msg_type",)).inc(1, msg_type=t)


def record_wire_stage(msg_type: Any, stage: str, nbytes: int) -> None:
    """Wire-pipeline seam: bytes attributed to one pipeline stage (raw /
    sparsified / masked) by message type."""
    if not _cfg["enabled"]:
        return
    REGISTRY.counter("fed_wire_stage_bytes_total",
                     "bytes by wire-pipeline stage and message type",
                     labels=("msg_type", "stage")).inc(
                         int(nbytes), msg_type=str(msg_type),
                         stage=str(stage))


def record_dispatch(name: str, wall_s: float, rounds: int,
                    compiles: int) -> None:
    """Dispatch seam (``mlops.log_dispatch``): dispatch wall time and the
    compile counter."""
    if not _cfg["enabled"]:
        return
    REGISTRY.histogram("fed_dispatch_wall_seconds",
                       "host wall time of one device dispatch",
                       buckets=WALL_BUCKETS,
                       labels=("dispatch",)).observe(float(wall_s),
                                                     dispatch=str(name))
    REGISTRY.counter("fed_dispatch_rounds_total",
                     "FL rounds carried by dispatches",
                     labels=("dispatch",)).inc(int(rounds),
                                               dispatch=str(name))
    if compiles:
        REGISTRY.counter("fed_xla_compiles_total",
                         "XLA backend compiles observed at dispatch "
                         "seams").inc(int(compiles))


def record_checkpoint_flush(wall_s: float) -> None:
    """``RoundCheckpointer.flush`` seam: the wall time the round loop
    blocks for its checkpoint writes."""
    if not _cfg["enabled"]:
        return
    REGISTRY.histogram("fed_checkpoint_flush_seconds",
                       "blocking checkpoint flush wall time",
                       buckets=WALL_BUCKETS).observe(float(wall_s))


def record_hbm_peak(gb: float) -> None:
    if not _cfg["enabled"]:
        return
    REGISTRY.gauge("fed_hbm_peak_gb",
                   "per-device peak memory allocated (GiB, "
                   "process-monotonic counter)").set(float(gb))


def record_round_mfu(mfu: float, tflops: Optional[float] = None) -> None:
    """Profiling plane: per-round model FLOPs utilization (the engine's
    FLOPs model, ``round_cost_flops``)."""
    if not _cfg["enabled"]:
        return
    REGISTRY.gauge("fed_round_mfu",
                   "per-round model FLOPs utilization").set(float(mfu))
    if tflops is not None:
        REGISTRY.gauge("fed_round_tflops",
                       "achieved TFLOP/s over the round").set(float(tflops))


def record_pour(staleness: Sequence[float], buffered: int,
                poured: int) -> None:
    """Async pour seam: staleness + buffer occupancy histograms."""
    if not _cfg["enabled"]:
        return
    h = REGISTRY.histogram("fed_pour_staleness",
                           "per-update staleness (versions) at pour time",
                           buckets=STALENESS_BUCKETS)
    for s in staleness:
        h.observe(float(s))
    REGISTRY.histogram("fed_buffer_occupancy",
                       "buffered update count after each pour",
                       buckets=OCCUPANCY_BUCKETS).observe(int(buffered))
    REGISTRY.counter("fed_pours_total", "pours executed").inc(1)
    REGISTRY.counter("fed_updates_poured_total",
                     "client updates aggregated by pours").inc(int(poured))


def record_arrival(latency_s: float, rate_mean: Optional[float] = None
                   ) -> None:
    """Async arrival seam: per-update latency histogram + the population
    arrival-rate gauge the adaptive staleness cap reads."""
    if not _cfg["enabled"]:
        return
    REGISTRY.histogram("fed_arrival_latency_seconds",
                       "dispatch-to-arrival latency of client updates",
                       buckets=LATENCY_BUCKETS).observe(float(latency_s))
    if rate_mean is not None and rate_mean > 0:
        REGISTRY.gauge("fed_arrival_rate_mean",
                       "population-mean client arrival rate "
                       "(updates/sec)").set(float(rate_mean))


def record_selection(strategy: str, sampled: int, excluded: int) -> None:
    """Selection seam: scheduled vs benched decisions per strategy."""
    if not _cfg["enabled"]:
        return
    c = REGISTRY.counter("fed_selection_decisions_total",
                         "participant-selection decisions",
                         labels=("strategy", "outcome"))
    c.inc(int(sampled), strategy=str(strategy), outcome="sampled")
    if excluded:
        c.inc(int(excluded), strategy=str(strategy), outcome="excluded")


def record_cohort_assembly(wall_s: float, scanned: int, eligible: int,
                           cohort: int, deadline_s: Optional[float] = None,
                           over_sample: Optional[float] = None) -> None:
    """Cross-device cohort-assembly seam (streaming eligibility scan +
    partial top-k + pacer): per-assembly wall histogram, scan/eligible
    counters, cohort-size gauge, and the pacer's live deadline /
    over-sample knobs. Round-less cross-device servers surface these via
    the wall-clock flusher (``obs_metrics_flush_s``)."""
    if not _cfg["enabled"]:
        return
    REGISTRY.histogram("fed_cohort_assembly_seconds",
                       "streaming cohort-assembly wall time",
                       buckets=WALL_BUCKETS).observe(float(wall_s))
    c = REGISTRY.counter("fed_cohort_candidates_total",
                         "candidate ids seen by cohort assembly",
                         labels=("outcome",))
    c.inc(int(scanned), outcome="scanned")
    c.inc(int(eligible), outcome="eligible")
    REGISTRY.gauge("fed_cohort_size",
                   "devices in the most recent cohort").set(int(cohort))
    if deadline_s is not None:
        REGISTRY.gauge("fed_cohort_pacer_deadline_seconds",
                       "pacer round deadline").set(float(deadline_s))
    if over_sample is not None:
        REGISTRY.gauge("fed_cohort_pacer_over_sample",
                       "pacer cohort over-sample factor").set(
                           float(over_sample))


class LatencyWindow:
    """Trailing-window latency store with EXACT nearest-rank percentiles —
    the one implementation of windowed tail stats (the serving gateway's
    p50/p99 and any autoscaler signal read this; the cumulative registry
    histograms remain the exposition/post-mortem view, fed separately by
    the ``record_*`` hooks)."""

    def __init__(self, window_s: float = 5.0):
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._events: Deque[Tuple[float, float]] = collections.deque()

    def observe(self, latency_s: float, ts: Optional[float] = None) -> None:
        now = time.time() if ts is None else float(ts)
        with self._lock:
            self._events.append((now, float(latency_s)))
            self._trim(now)

    def _trim(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()

    @staticmethod
    def _rank(lats: List[float], q: float) -> float:
        n = len(lats)
        return lats[min(n - 1, int(q * (n - 1) + 0.5))]

    def stats(self) -> Tuple[float, float, float, float, int]:
        """``(qps, mean, p50, p99, count)`` over the trailing window."""
        now = time.time()
        with self._lock:
            self._trim(now)
            lats = sorted(l for _, l in self._events)
        n = len(lats)
        if not n:
            return 0.0, 0.0, 0.0, 0.0, 0
        return (n / self.window_s, sum(lats) / n,
                self._rank(lats, 0.50), self._rank(lats, 0.99), n)


_flush_state = {"last": None}

# wall-clock flusher state: at most one live daemon thread per process —
# ownership is `_wall_flush["thread"] is current_thread()`, so a
# re-configure (new interval, or 0 = off) retires the old loop instead
# of stacking threads
_wall_flush = {"interval_s": 0.0, "thread": None, "last_ts": 0.0}


def set_flush_interval(seconds: float) -> None:
    """Wall-clock snapshot cadence (``obs_metrics_flush_s``; 0 = off).

    The round-boundary flusher (:func:`maybe_flush`) fires only where a
    loop crosses rounds; serving never does, so without this its metrics
    exist only in the final :func:`flush_final` snapshot. The wall-clock
    loop emits a ``metrics_snapshot`` every ``seconds``, but only when an
    instrument changed since the last flush (the activity epoch), so an
    idle process stays silent."""
    interval = max(float(seconds or 0.0), 0.0)
    _wall_flush["interval_s"] = interval
    if interval <= 0:
        _wall_flush["thread"] = None  # orphan the loop; it exits itself
        return
    th = _wall_flush["thread"]
    if th is not None and th.is_alive():
        return  # the live loop re-reads interval_s every tick

    def loop() -> None:
        me = threading.current_thread()
        while _wall_flush["thread"] is me:
            ivl = _wall_flush["interval_s"]
            if ivl <= 0:
                return
            time.sleep(min(ivl, 1.0))
            # re-check after the sleep: a disable (or takeover) during
            # the nap must not let one more flush slip through
            if (_wall_flush["thread"] is not me
                    or _wall_flush["interval_s"] <= 0):
                return
            now = time.time()
            if now - _wall_flush["last_ts"] < _wall_flush["interval_s"]:
                continue
            if not _cfg["enabled"]:
                continue
            if _activity["epoch"] == _activity["flushed"]:
                continue  # nothing changed since the last snapshot
            _wall_flush["last_ts"] = now
            try:
                REGISTRY.flush()
            except Exception:  # pragma: no cover — sink died mid-run
                pass

    t = threading.Thread(target=loop, daemon=True,
                         name="obs-metrics-wall-flush")
    _wall_flush["thread"] = t
    t.start()


def maybe_flush(round_idx: int) -> None:
    """Round-boundary hook (``sink.log_round_info``): snapshot every
    ``obs_metrics_flush_rounds`` rounds. Deduped per round — fused blocks
    replay round boundaries in bursts."""
    every = _cfg["flush_every"]
    if not _cfg["enabled"] or every <= 0:
        return
    if round_idx % every == 0 and _flush_state["last"] != round_idx:
        _flush_state["last"] = round_idx
        REGISTRY.flush(step=round_idx)


def flush_final(step: Optional[int] = None) -> None:
    """Unconditional end-of-run snapshot (engines' ``run()`` end, the
    server's ``finish_session``): without it, everything accumulated
    since the last cadence boundary — the final rounds' wire bytes,
    staleness histograms, MFU — would die with the process and the run
    log would NOT be self-contained."""
    if not _cfg["enabled"]:
        return
    REGISTRY.flush(step=step)


def record_fleet_round(task_id: str, cohort: int, denied_busy: int,
                       denied_cap: int) -> None:
    """Multi-tenant fleet-plane seam (core/fleet): per-task selected
    devices plus the fairness arbiter's denial counts — ``busy`` is the
    one-task-per-round rule firing, ``cap`` the trailing-window
    participation cap. A healthy single-tenant fleet shows zero of
    both; a saturated multi-tenant one shows busy denials growing."""
    if not _cfg["enabled"]:
        return
    c = REGISTRY.counter("fed_fleet_devices_total",
                         "fleet-plane per-task device decisions",
                         labels=("task", "outcome"))
    c.inc(int(cohort), task=str(task_id), outcome="selected")
    if denied_busy:
        c.inc(int(denied_busy), task=str(task_id), outcome="denied_busy")
    if denied_cap:
        c.inc(int(denied_cap), task=str(task_id), outcome="denied_cap")
    REGISTRY.gauge("fed_fleet_cohort_size",
                   "devices granted to the most recent fleet round",
                   labels=("task",)).set(int(cohort), task=str(task_id))


def record_roofline(program: str, predicted_mfu: Optional[float],
                    memory_bound_share: Optional[float],
                    collective_wire_bytes: Optional[float]) -> None:
    """Compute-plane roofline capture (core/obs/roofline): predicted
    program MFU, time share classified memory-bound, and the per-device
    collective wire bytes one execution moves."""
    if not _cfg["enabled"]:
        return
    if predicted_mfu is not None:
        REGISTRY.gauge("roofline_predicted_mfu",
                       "roofline-predicted program MFU",
                       labels=("program",)).set(float(predicted_mfu),
                                                program=str(program))
    if memory_bound_share is not None:
        REGISTRY.gauge("roofline_memory_bound_share",
                       "share of predicted device time in memory-bound "
                       "ops", labels=("program",)).set(
                           float(memory_bound_share),
                           program=str(program))
    if collective_wire_bytes is not None:
        REGISTRY.gauge("roofline_collective_wire_bytes",
                       "predicted per-device collective wire bytes per "
                       "program execution",
                       labels=("program",)).set(
                           float(collective_wire_bytes),
                           program=str(program))
    REGISTRY.counter("roofline_captures_total",
                     "compiled programs analyzed by the roofline "
                     "plane").inc(1)


def record_recompile(program: str) -> None:
    """Recompile forensics: a program compiled PAST its pinned
    expectation (the steady-state invariant is zero)."""
    if not _cfg["enabled"]:
        return
    REGISTRY.counter("roofline_recompiles_total",
                     "dispatches that recompiled past the pinned "
                     "one-compile expectation",
                     labels=("program",)).inc(1, program=str(program))
