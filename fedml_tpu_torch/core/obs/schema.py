"""Canonical schema for every JSONL record kind the mlops sink emits (a
copy of ``fedml_tpu/core/obs/schema.py``: the port's records pass the JAX
package's table).

One table, one validator: every record crossing ``mlops._emit`` has a
``kind`` listed here, carries the common envelope (``kind``/``ts``/
``run_id``), and types its fields as declared. The tier-1 replay test
runs a small engine session and validates EVERY line of the run log
against this table — so a new record kind (or a silently-retyped field)
fails CI instead of quietly producing logs ``trace_report``/dashboards
cannot parse.

The validator is deliberately tolerant of EXTRA fields (records grow;
readers must ignore what they don't know) and strict about declared ones
(required present, types as stated). ``None`` is allowed exactly where
the spec says so.
"""

from __future__ import annotations

import numbers
import re
from typing import Any, Dict, List, Tuple

_HEX32 = re.compile(r"^[0-9a-f]{32}$")
_HEX16 = re.compile(r"^[0-9a-f]{16}$")

# sentinels for the spec table
NUM = "num"          # int or float (bools rejected)
INT = "int"
STR = "str"
BOOL = "bool"
DICT = "dict"
LIST = "list"
ANY = "any"
HEX32 = "hex32"      # 32-char lowercase hex (trace ids)
HEX16 = "hex16"      # 16-char lowercase hex (span ids)

# field spec: (type sentinel, required, nullable)
FieldSpec = Tuple[str, bool, bool]


def _f(ty: str, required: bool = False, nullable: bool = False) -> FieldSpec:
    return (ty, required, nullable)


# the common envelope _emit stamps on every record
ENVELOPE: Dict[str, FieldSpec] = {
    "kind": _f(STR, required=True),
    "ts": _f(NUM, required=True),
    "run_id": _f(STR, required=True),
}

RECORD_SCHEMAS: Dict[str, Dict[str, FieldSpec]] = {
    # mlops.log / log_metric
    "metric": {"metrics": _f(DICT, required=True),
               "step": _f(INT, nullable=True)},
    # mlops.log_round_info
    "round": {"round_idx": _f(INT, required=True),
              "total_rounds": _f(INT, required=True)},
    # mlops.log_comm_round (WireStats ledger diff per FL round)
    "comm": {"round_idx": _f(INT, required=True),
             "wire_bytes": _f(INT, required=True),
             "compression": _f(STR, nullable=True),
             "by_type": _f(DICT, nullable=True)},
    # mlops.log_chaos (fault ledger mirror; arrivals = per-pour records)
    "chaos": {"round_idx": _f(INT),
              "injected": _f(DICT),
              "observed": _f(DICT),
              "link": _f(DICT),
              "arrivals": _f(LIST),
              "serving": _f(DICT)},
    # mlops.log_selection
    "selection": {"round_idx": _f(INT, required=True),
                  "strategy": _f(STR, required=True),
                  "sampled": _f(LIST),
                  "excluded": _f(LIST),
                  "target_n": _f(INT),
                  "dropout_posterior": _f(NUM)},
    # mlops.log_dispatch (engine _traced seam)
    "dispatch": {"dispatch": _f(STR, required=True),
                 "wall_s": _f(NUM, required=True),
                 "rounds": _f(INT, required=True),
                 "compiles": _f(INT, required=True)},
    # mlops.log_training_status / log_aggregation_status
    "status": {"role": _f(STR, required=True),
               "status": _f(STR, required=True)},
    # mlops.log_model_info
    "model": {"round_idx": _f(INT, required=True),
              "path": _f(STR, required=True)},
    # legacy event pair records (kept as the mlops.event shim's output
    # next to the tracer's span records)
    "event_start": {"event": _f(STR, required=True),
                    "value": _f(ANY, nullable=True)},
    "event_end": {"event": _f(STR, required=True),
                  "value": _f(ANY, nullable=True),
                  "duration_s": _f(NUM, nullable=True)},
    # mlops.start_sys_perf sampler
    "sys_perf": {"cpu_pct": _f(NUM),
                 "mem_pct": _f(NUM),
                 "mem_used_gb": _f(NUM),
                 "device_mem_gb": _f(NUM),
                 "degraded": _f(BOOL)},
    # core/obs/trace.py span emission
    "span": {"name": _f(STR, required=True),
             "trace_id": _f(HEX32, required=True),
             "span_id": _f(HEX16, required=True),
             "parent_id": _f(HEX16, required=True, nullable=True),
             "start_ts": _f(NUM, required=True),
             "end_ts": _f(NUM, required=True),
             "duration_s": _f(NUM, required=True),
             "pid": _f(INT, required=True),
             "attrs": _f(DICT),
             "events": _f(LIST),
             "links": _f(LIST)},
    # core/obs/metrics.py registry flush
    "metrics_snapshot": {"metrics": _f(DICT, required=True),
                         "step": _f(INT, nullable=True)},
    # core/obs/profiler.py dispatch profile
    "profile": {"dispatch": _f(STR, required=True),
                "rounds": _f(INT, required=True),
                "host_s": _f(NUM, required=True),
                "total_s": _f(NUM, required=True),
                "device_wait_s": _f(NUM),
                "compiles": _f(INT),
                "tflops": _f(NUM),
                "mfu": _f(NUM)},
    # mlops.log_health — component health transitions: watchdog trips
    # (status: stalled | nan_logits), serving /healthz state changes
    "health": {"component": _f(STR, required=True),
               "status": _f(STR, required=True),
               "detail": _f(DICT, nullable=True)},
    # core/obs/flight.py ring-buffer dump: one line per recorded event,
    # oldest first — the black-box artifact validates like a run log
    "flight": {"component": _f(STR, required=True),
               "seq": _f(INT, required=True),
               "event": _f(STR, required=True),
               "data": _f(DICT)},
    # core/obs/roofline.py per-program compute-plane capture: one record
    # per (program, abstract-shape signature), opt-in (obs_roofline).
    # ``ops`` rows carry name/op/out/operands/flops/bytes/intensity/
    # bound/time_s/share; ``collectives`` rows op/group/count/wire_bytes
    "roofline": {"program": _f(STR, required=True),
                 "device_kind": _f(STR, required=True),
                 "n_devices": _f(INT, required=True),
                 "static_only": _f(BOOL, required=True),
                 "peak_tflops": _f(NUM, nullable=True),
                 "hbm_gbps": _f(NUM, nullable=True),
                 "balance_flops_per_byte": _f(NUM, nullable=True),
                 "total_flops": _f(NUM, required=True),
                 "total_bytes": _f(NUM, required=True),
                 "predicted_s": _f(NUM, required=True),
                 "predicted_mfu": _f(NUM, required=True, nullable=True),
                 "attributed_share": _f(NUM, required=True),
                 "memory_bound_share": _f(NUM, required=True),
                 "compute_bound_share": _f(NUM),
                 "collective_wire_bytes": _f(NUM, required=True),
                 "xla_flops": _f(NUM, nullable=True),
                 "xla_bytes": _f(NUM, nullable=True),
                 "arg_bytes": _f(NUM),
                 "output_bytes": _f(NUM),
                 "temp_bytes": _f(NUM),
                 "ops": _f(LIST, required=True),
                 "collectives": _f(LIST, required=True)},
    # core/obs/roofline.py recompile forensics: the compile counter
    # incremented past the pinned one-compile-per-program expectation;
    # ``changed`` names the abstract arg shapes that moved (empty =
    # cache miss with identical shapes — new callable / jit options)
    "recompile": {"program": _f(STR, required=True),
                  "compiles": _f(INT, required=True),
                  "total_compiles": _f(INT, required=True),
                  "expected": _f(INT),
                  "changed": _f(LIST, required=True),
                  "note": _f(STR, nullable=True)},
}

# Span names the serving request lifecycle emits (engine + HTTP surface).
# scripts/serving_report.py keys its waterfall on these; the e2e trace
# test pins that every emitted serving span uses a name from this set,
# so the report and the instrumentation cannot drift apart.
SERVING_SPAN_NAMES = frozenset({
    "serving.http",          # replica/gateway HTTP receive -> reply
    "serving.request",       # submit -> finish (the per-request root)
    "serving.queue",         # submit -> admission (queue wait)
    "serving.prefill",       # chunked prefill inside admit
    "serving.decode",        # first token -> finish/evict
    "serving.decode_steps",  # shared engine-side step block (fan-in links)
})


def _type_ok(ty: str, v: Any) -> bool:
    if ty == ANY:
        return True
    if ty == NUM:
        return isinstance(v, numbers.Real) and not isinstance(v, bool)
    if ty == INT:
        return isinstance(v, numbers.Integral) and not isinstance(v, bool)
    if ty == STR:
        return isinstance(v, str)
    if ty == BOOL:
        return isinstance(v, bool)
    if ty == DICT:
        return isinstance(v, dict)
    if ty == LIST:
        return isinstance(v, (list, tuple))
    if ty == HEX32:
        return isinstance(v, str) and _HEX32.match(v) is not None
    if ty == HEX16:
        return isinstance(v, str) and _HEX16.match(v) is not None
    raise ValueError(f"unknown type sentinel {ty!r}")


def validate_record(rec: Any) -> List[str]:
    """Validate one decoded JSONL record; returns a list of problems
    (empty = valid). Never raises on malformed input — validation runs
    over logs from crashed runs too."""
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]
    errs: List[str] = []
    kind = rec.get("kind")
    for name, (ty, required, nullable) in ENVELOPE.items():
        if name not in rec:
            errs.append(f"missing envelope field {name!r}")
        elif rec[name] is None:
            if not nullable:
                errs.append(f"envelope field {name!r} is null")
        elif not _type_ok(ty, rec[name]):
            errs.append(f"envelope field {name!r} has type "
                        f"{type(rec[name]).__name__}, want {ty}")
    if not isinstance(kind, str):
        return errs or ["record has no usable 'kind'"]
    spec = RECORD_SCHEMAS.get(kind)
    if spec is None:
        errs.append(f"unknown record kind {kind!r}")
        return errs
    for name, (ty, required, nullable) in spec.items():
        if name not in rec:
            if required:
                errs.append(f"{kind}: missing required field {name!r}")
            continue
        v = rec[name]
        if v is None:
            if not nullable:
                errs.append(f"{kind}: field {name!r} is null")
            continue
        if not _type_ok(ty, v):
            errs.append(f"{kind}: field {name!r} has type "
                        f"{type(v).__name__}, want {ty}")
    return errs


def validate_lines(lines) -> List[Tuple[int, str]]:
    """Validate an iterable of raw JSONL lines; returns [(lineno, error)]
    over every problem found (blank lines skipped)."""
    import json
    problems: List[Tuple[int, str]] = []
    for i, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError as e:
            problems.append((i, f"not JSON: {e}"))
            continue
        for err in validate_record(rec):
            problems.append((i, err))
    return problems
