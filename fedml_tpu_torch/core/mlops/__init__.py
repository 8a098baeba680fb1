"""Observability façade (counterpart of ``fedml_tpu/core/mlops``).

The user-facing surface of the JAX package's ``mlops`` —
``init/log/event/log_metric/log_round_info/log_comm_round/log_chaos/...`` —
over the port's one record funnel, :mod:`..obs.sink`: every record goes
through ``sink.emit`` (the JAX package's ``mlops._emit``), and the round,
chaos and selection records are the sink's own functions, re-exported
here, so a record written by either path has the same JSON keys as the
JAX package's. :func:`init` installs the run's JSONL file as the sink's
file destination (``enable_tracking``, ``log_file_dir``), starts the log
shipper (``log_server_url``) and the system sampler
(``sys_perf_profiling``), and wires the ``obs_*`` knobs.

Device parts run on PyTorch: the sampler reads the CUDA allocator of the
run's device, and the device trace is ``torch.profiler``'s.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import threading
import time
from typing import Any, Dict, Optional

from ..obs import metrics as obs_metrics
from ..obs import sink as _sink
from ..obs import trace as obs_trace
from ..obs.sink import log_chaos, log_round_info, log_selection

__all__ = [
    "JsonSink", "init", "log", "log_metric", "log_round_info",
    "log_comm_round", "log_chaos", "log_selection", "log_dispatch",
    "install_compile_counter", "compile_count", "log_training_status",
    "log_aggregation_status", "log_model_info", "log_health", "event",
    "start_sys_perf", "stop_sys_perf", "start_device_trace",
    "stop_device_trace",
]

logger = logging.getLogger(__name__)

_state: Dict[str, Any] = {"enabled": False, "sink": None,
                          "sys_thread": None, "device": None,
                          "profiler": None}


def _json_default(obj: Any) -> Any:
    """numpy scalars and arrays, and tensors, as JSON numbers / lists."""
    if hasattr(obj, "tolist"):
        return obj.tolist()
    if hasattr(obj, "item"):
        return obj.item()
    raise TypeError(f"{type(obj).__name__} is not JSON serializable")


class JsonSink:
    """Append-only JSON-lines sink — one file per run, thread-safe."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self._lock = threading.Lock()
        atexit.register(self.close)

    def emit(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self._f.write(json.dumps(record, default=_json_default) + "\n")

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass


def init(args, device=None) -> None:
    """Wire the record plane from ``args`` (the JAX package's
    ``mlops.init``). Tracking is on by default and off with
    ``enable_tracking: false``; an unwritable log dir degrades to disabled
    instead of failing. ``device`` is the run's device, which the system
    sampler reads."""
    run_id = str(getattr(args, "run_id", "0"))
    _state["enabled"] = bool(getattr(args, "enable_tracking", True))
    _state["device"] = device
    from .. import obs
    obs.configure(args)
    prev = _state.get("sink")
    if prev is not None:
        prev.close()
    _state["sink"] = None
    _sink.set_file_sink(None, run_id=run_id)
    prev_shipper = _state.pop("shipper", None)
    if prev_shipper is not None:
        prev_shipper.stop()
    if not _state["enabled"]:
        return
    log_dir = os.path.expanduser(
        getattr(args, "log_file_dir", None) or "~/.cache/fedml_tpu/logs")
    path = os.path.join(log_dir, f"run_{run_id}.jsonl")
    try:
        _state["sink"] = JsonSink(path)
    except OSError as e:
        logger.warning("mlops sink unavailable (%s); tracking disabled", e)
        _state["enabled"] = False
        return
    _sink.set_file_sink(_state["sink"].emit, run_id=run_id)
    log_url = (getattr(args, "log_server_url", None)
               or os.environ.get("FEDML_TPU_LOG_SERVER_URL"))
    if log_url:
        from .log_daemon import start_log_shipper
        _state["shipper"] = start_log_shipper(
            path, log_url, run_id=run_id,
            device_id=str(getattr(args, "device_id", 0)))
    if bool(getattr(args, "sys_perf_profiling", False)):
        start_sys_perf()


def log_path() -> Optional[str]:
    """The run's JSONL file, when tracking is on."""
    sink = _state.get("sink")
    return None if sink is None else sink._f.name


_emit = _sink.emit


def log(metrics: Dict[str, Any], step: Optional[int] = None) -> None:
    _emit("metric", {"metrics": metrics, "step": step})


def log_metric(metrics: Dict[str, Any], step: Optional[int] = None) -> None:
    log(metrics, step)


def log_comm_round(round_idx: int, wire_bytes: int,
                   compression: Optional[str] = None,
                   by_type: Optional[Dict[str, Any]] = None) -> None:
    """Bytes-on-wire for one FL round, as recorded by the ``WireStats``
    ledger at the ``Message.encode`` seam (``wire_bytes`` is the diff of
    the ledger across the round; ``by_type`` optionally carries the
    per-message-type breakdown of a full snapshot)."""
    _emit("comm", {"round_idx": round_idx, "wire_bytes": int(wire_bytes),
                   "compression": compression, "by_type": by_type})


def log_dispatch(name: str, wall_s: float, rounds: int = 1,
                 compiles: int = 0) -> None:
    """One device dispatch: host wall time of the dispatch call, the FL
    rounds it carried and the compiles it triggered (always 0 here, see
    :func:`compile_count`)."""
    obs_metrics.record_dispatch(name, wall_s, rounds, compiles)
    _emit("dispatch", {"dispatch": name, "wall_s": round(float(wall_s), 6),
                       "rounds": int(rounds), "compiles": int(compiles)})


# --- compile counter --------------------------------------------------------
# The JAX package counts XLA backend compiles through jax.monitoring. The
# port compiles nothing on the paths it runs (eager PyTorch, CUDA graphs
# captured once, kernels built once per source by nvcc before the run),
# so the API stays and the count stays 0.

_compile_counter: Dict[str, Any] = {"count": 0, "installed": False}


def install_compile_counter() -> None:
    """Idempotent; nothing to listen to (see :func:`compile_count`)."""
    _compile_counter["installed"] = True


def compile_count() -> int:
    """Backend compiles observed in this process: 0. The port runs no
    just-in-time compiler on its paths (``torch.compile`` is not used;
    a captured CUDA graph is counted by the engines as ``captures``)."""
    return int(_compile_counter["count"])


def log_training_status(status: str, run_id: Optional[str] = None) -> None:
    _emit("status", {"role": "client", "status": status})


def log_aggregation_status(status: str, run_id: Optional[str] = None) -> None:
    _emit("status", {"role": "server", "status": status})


def log_model_info(round_idx: int, model_path: str) -> None:
    _emit("model", {"round_idx": round_idx, "path": model_path})


def log_health(component: str, status: str,
               detail: Optional[Dict[str, Any]] = None) -> None:
    """One component health transition (watchdog trips, ``/healthz``
    state changes)."""
    _emit("health", {"component": str(component), "status": str(status),
                     "detail": detail})


# --- event spans ------------------------------------------------------------

class event:
    """Span context manager / pair API over the tracer (the JAX package's
    ``mlops.event`` shim):

        with mlops.event("train", round_idx=3): ...
    or  mlops.event("train", started=True); ...; mlops.event("train",
        started=False)

    The context-manager form holds its span on the instance; the pair form
    keeps per-``(thread, name)`` LIFO stacks under a lock (a cross-thread
    close falls back to any thread's innermost open span of that name).
    Both also write the ``event_start`` / ``event_end`` records."""

    _open_lock = threading.Lock()
    _open: Dict[Any, list] = {}

    def __init__(self, name: str, started: Optional[bool] = None,
                 value: Any = None, **extra: Any):
        self.name = name
        self.extra = extra
        self._span = None
        if started is True:
            sp = obs_trace.tracer.start_span(name, attrs=dict(extra))
            with event._open_lock:
                event._open.setdefault(
                    (threading.get_ident(), name), []).append(
                    (sp, time.time()))
            _emit("event_start", {"event": name, "value": value, **extra})
        elif started is False:
            handle = self._pop_open(name)
            dur = None
            if handle is not None:
                sp, t0 = handle
                sp.end()
                dur = time.time() - t0
            _emit("event_end", {"event": name, "value": value,
                                "duration_s": dur, **extra})

    @classmethod
    def _pop_open(cls, name: str):
        tid = threading.get_ident()
        with cls._open_lock:
            stack = cls._open.get((tid, name))
            if not stack:
                for key in reversed(list(cls._open)):
                    if key[1] == name and cls._open[key]:
                        stack = cls._open[key]
                        break
            if not stack:
                return None
            sp = stack.pop()
            if not stack:
                cls._open = {k: v for k, v in cls._open.items() if v}
            return sp

    def __enter__(self):
        self._span = obs_trace.tracer.start_span(self.name,
                                                 attrs=dict(self.extra))
        self._span.__enter__()
        self._t0 = time.time()
        _emit("event_start", {"event": self.name, **self.extra})
        return self

    def __exit__(self, *exc):
        dur = time.time() - self._t0
        self._span.__exit__(*exc)
        _emit("event_end", {"event": self.name, "duration_s": dur,
                            **self.extra})
        return False


# --- system perf sampler ----------------------------------------------------

_sys_perf_state = {"psutil_warned": False, "sample_warned": False}


def _sys_sample() -> Dict[str, Any]:
    """One host + device sample. psutil is optional: without it the host
    fields degrade away once, loudly, and the device fields keep
    flowing. The device fields read the CUDA allocator of the run's
    device (``memory_stats`` / ``mem_get_info``), where there is one."""
    rec: Dict[str, Any] = {}
    try:
        import psutil
        vm = psutil.virtual_memory()
        rec.update({"cpu_pct": psutil.cpu_percent(interval=None),
                    "mem_pct": vm.percent,
                    "mem_used_gb": round(vm.used / 2**30, 3)})
    except Exception as e:
        if not _sys_perf_state["psutil_warned"]:
            _sys_perf_state["psutil_warned"] = True
            logger.warning(
                "sys_perf: psutil unavailable (%s: %s) — degrading to "
                "device stats", type(e).__name__, e)
        rec["degraded"] = True
    try:
        import torch
        dev = _state.get("device")
        dev = torch.device(dev) if dev is not None else None
        if (dev is None or dev.type == "cuda") and torch.cuda.is_available():
            stats = torch.cuda.memory_stats(dev)
            if "allocated_bytes.all.current" in stats:
                rec["device_mem_gb"] = round(
                    stats["allocated_bytes.all.current"] / 2**30, 3)
            free, total = torch.cuda.mem_get_info(dev)
            rec["device_mem_used_gb"] = round((total - free) / 2**30, 3)
    except Exception:
        pass
    return rec


def start_sys_perf(interval_s: float = 10.0) -> None:
    if _state.get("sys_thread"):
        return

    def loop():
        # identity check: a stop+start within one interval must not leave
        # the old thread alive emitting duplicates
        while _state.get("sys_thread") is threading.current_thread():
            try:
                _emit("sys_perf", _sys_sample())
            except Exception:
                if not _sys_perf_state["sample_warned"]:
                    _sys_perf_state["sample_warned"] = True
                    logger.warning("sys_perf sample failed; sampler "
                                   "continues", exc_info=True)
            time.sleep(interval_s)

    t = threading.Thread(target=loop, daemon=True)
    _state["sys_thread"] = t
    t.start()


def stop_sys_perf() -> None:
    _state["sys_thread"] = None


# --- device trace (torch.profiler) ------------------------------------------

def start_device_trace(log_dir: Optional[str] = None) -> str:
    """Start a ``torch.profiler`` trace of the host and, where there is
    one, the CUDA device; :func:`stop_device_trace` writes it as a Chrome
    trace under ``log_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    path = os.path.expanduser(log_dir or "~/.cache/fedml_tpu/traces")
    os.makedirs(path, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    _state["profiler"] = (prof, path)
    return path


def stop_device_trace() -> Optional[str]:
    """Stop the trace :func:`start_device_trace` began; returns the trace
    file's path (None when none was running)."""
    handle = _state.pop("profiler", None)
    if handle is None:
        return None
    prof, path = handle
    prof.__exit__(None, None, None)
    out = os.path.join(path, f"trace_{os.getpid()}_{int(time.time())}.json")
    prof.export_chrome_trace(out)
    return out
