"""Serving SDK: ``FedMLPredictor`` + ``FedMLInferenceRunner``
(counterpart of ``fedml_tpu/serving/__init__.py``).

The HTTP layer is the stdlib ``ThreadingHTTPServer``: POST ``/predict``
(and any route a template mounts) with a JSON body, GET ``/ready``,
``/metrics`` (Prometheus text of the obs registry), ``/healthz`` and
``/debug/state``. :class:`Overloaded` is the load-shed verdict (HTTP 503 +
``Retry-After``); :class:`SSEStream` a route's streaming verdict.

Model artifacts (``save_model`` / ``load_model``) are msgpack-encoded
trees, the wire codec of ``core/distributed/communication/message.py``
behind a magic header, never pickle: loading a served artifact must not be
a code-execution vector. An artifact holds the nested flax tree the JAX
package writes (``interop.state_dict_to_flax`` of the port's state dict),
so the two packages write the same bytes for the same parameters and read
each other's artifacts. :class:`CheckpointPredictor` serves a trained
classifier from one.
"""

from __future__ import annotations

import json
import logging
import threading
from abc import ABC, abstractmethod
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..core.distributed.communication.message import dumps_tree, loads_tree

logger = logging.getLogger(__name__)

PyTree = Any

# artifact magic: lets load_model fail loudly (instead of unpacking
# garbage) on foreign files, and marks the format as the msgpack codec
_ARTIFACT_MAGIC = b"FMTPU1\n"


class Overloaded(RuntimeError):
    """Load-shed verdict: the serving queue is past its depth bound, so
    the request is refused AT SUBMIT instead of wedging the queue —
    overload is a signal, not a hang. ``retry_after_s`` (derived from
    queue depth and KV admission headroom) rides out as the HTTP 503's
    ``Retry-After`` header so well-behaved clients back off usefully."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = max(float(retry_after_s), 0.0)


class SSEStream:
    """A route handler's STREAMING verdict: instead of one JSON body,
    the HTTP layer writes each yielded event as a ``text/event-stream``
    ``data:`` frame (dicts are JSON-encoded; strings pass through),
    closing with ``data: [DONE]`` — the OpenAI streaming wire shape, so
    existing OpenAI streaming clients consume a served federated
    fine-tune unchanged. Errors raised by the iterator AFTER the headers
    went out surface as a final ``data: {"error": ...}`` frame (the
    status line is already on the wire; a mid-stream 500 is not a thing
    HTTP has)."""

    def __init__(self, events, headers: Optional[dict] = None):
        self.events = events
        self.headers = dict(headers or {})


def _is_state_dict(params: PyTree) -> bool:
    return (isinstance(params, Mapping) and len(params) > 0 and all(
        isinstance(v, (torch.Tensor, np.ndarray)) for v in params.values()))


def save_model(params: PyTree, path: str) -> str:
    """Persist model params with the wire codec (``dumps_tree``), through
    a temporary file and ``os.replace`` so a reader never sees half an
    artifact. A flat dict of tensors or arrays is the port's state dict
    and is written as its nested flax tree (the JAX package's layout);
    any other tree is written as it is."""
    import os

    from ..interop import state_dict_to_flax
    tree = state_dict_to_flax(params) if _is_state_dict(params) else params
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_ARTIFACT_MAGIC)
        f.write(dumps_tree(tree))
    os.replace(tmp, path)
    return path


def check_model_magic(path: str) -> None:
    """Cheap receive-time validation: existence + magic header, without
    unpacking the whole artifact (which the consumer will do anyway)."""
    with open(path, "rb") as f:
        if f.read(len(_ARTIFACT_MAGIC)) != _ARTIFACT_MAGIC:
            raise ValueError(
                f"{path}: not a fedml_tpu model artifact (bad magic)")


def load_model(path: str) -> PyTree:
    """The tree a ``save_model`` artifact holds (nested, numpy leaves);
    ``interop.flax_to_state_dict`` makes it the port's state dict."""
    with open(path, "rb") as f:
        head = f.read(len(_ARTIFACT_MAGIC))
        if head != _ARTIFACT_MAGIC:
            raise ValueError(
                f"{path}: not a fedml_tpu model artifact (bad magic); "
                "legacy pickle artifacts are not loaded — re-save with "
                "save_model")
        return loads_tree(f.read())


class FedMLPredictor(ABC):
    """User-implemented predictor (reference ``fedml_predictor.py:4``)."""

    @abstractmethod
    def predict(self, request: Any) -> Any:
        """Map one JSON-decoded request to a JSON-encodable response."""

    def ready(self) -> bool:
        return True


class CheckpointPredictor(FedMLPredictor):
    """Serve a trained classifier: request ``{"inputs": [[...], ...]}``
    (NHWC images or flat features, as the model takes them) -> response
    ``{"outputs": logits, "classes": argmax}``. The forward is the
    bundle's ``apply`` on ``device`` (CUDA unless ``"cpu"``), in the
    bundle's compute dtype and with its fused conv block setting: the
    engine's own eval forward."""

    def __init__(self, bundle, params: PyTree, device=None):
        from ..device import get_device
        from ..interop import flax_to_state_dict
        from ..simulation.gpu.engine import load_params
        self.device = get_device(device)
        self.bundle = bundle
        if not _is_state_dict(params):   # a nested (flax) tree
            params = flax_to_state_dict(params)
        self.params = load_params(bundle, params, self.device)

    @classmethod
    def from_files(cls, args, params_path: str, output_dim: int,
                   input_shape=None, device=None) -> "CheckpointPredictor":
        """The model named by ``args`` (``model``, ``precision``,
        ``fused_conv_block``; the linear models need ``input_shape``)
        with the params of a ``save_model`` artifact."""
        from ..model import create
        bundle = create(args, output_dim, input_shape)
        return cls(bundle, load_model(params_path), device=device)

    def predict(self, request: Any) -> Any:
        x = torch.from_numpy(np.asarray(request["inputs"], np.float32))
        with torch.no_grad():
            logits = self.bundle.apply(self.params, x.to(self.device))
        logits = logits.cpu().numpy()
        return {"outputs": logits.tolist(),
                "classes": logits.argmax(-1).tolist()}


class FedMLInferenceRunner:
    """HTTP wrapper: POST /predict, GET /ready (reference
    ``fedml_inference_runner.py:8-39``). ``start()`` serves on a background
    thread and returns the bound port; ``run()`` blocks.

    Operator surface (the serving observability plane):

    * ``GET /metrics`` — Prometheus text exposition of the process-wide
      ``core/obs`` registry (TTFT/ITL histograms, KV-pool gauges, ...);
    * ``GET /healthz`` — liveness JSON from the predictor's ``health()``
      when it has one (503 on a non-``ok`` status — the watchdog's view);
    * ``GET /debug/state`` — the predictor's ``debug_state()`` (slot
      matrix, block-table summary, queue snapshot) for live inspection.

    Tracing: a ``POST`` carrying a W3C ``traceparent`` header joins the
    caller's trace — the handler wraps the route in a ``serving.http``
    span parented on the header (or a fresh root), active on the handler
    thread so the engine's per-request spans nest under it, and echoes
    the span's ``traceparent`` on the response."""

    def __init__(self, predictor: FedMLPredictor, host: str = "127.0.0.1",
                 port: int = 0,
                 extra_routes: Optional[dict] = None,
                 chaos=None):
        from ..core.obs import metrics as obs_metrics
        from ..core.obs import trace as obs_trace

        self.predictor = predictor
        if chaos is not None:
            raise NotImplementedError(
                "replica crash injection (chaos=) needs core/chaos, which "
                "is not ported to fedml_tpu_torch yet")
        # POST routes: path -> callable(json_request) -> json_response.
        # /predict is always mounted; templates mount more (e.g. the LLM
        # template's /v1/chat/completions)
        self.routes = {"/predict": predictor.predict}
        self.routes.update(extra_routes or {})
        runner = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args_):  # quiet by default
                logger.debug("serving: " + fmt, *args_)

            def _reply(self, code: int, payload: Any,
                       traceparent: Optional[str] = None,
                       extra_headers: Optional[dict] = None) -> None:
                blob = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(blob)))
                if traceparent:
                    self.send_header("traceparent", traceparent)
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(blob)

            def _reply_text(self, code: int, text: str) -> None:
                blob = text.encode()
                self.send_response(code)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

            def _reply_stream(self, stream: SSEStream,
                              traceparent: Optional[str] = None) -> None:
                """Write an SSE event stream (no Content-Length; the
                HTTP/1.0 connection close delimits the body, so plain
                read-to-EOF clients work)."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                if traceparent:
                    self.send_header("traceparent", traceparent)
                for k, v in stream.headers.items():
                    self.send_header(k, str(v))
                self.end_headers()
                events = iter(stream.events)
                try:
                    for ev in events:
                        blob = ev if isinstance(ev, str) else json.dumps(ev)
                        self.wfile.write(f"data: {blob}\n\n".encode())
                        self.wfile.flush()
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    # client went away mid-stream: stop generating
                    close = getattr(events, "close", None)
                    if close is not None:
                        close()
                except Exception as e:  # noqa: BLE001 — headers are out
                    logger.exception("stream handler failed mid-stream")
                    try:
                        self.wfile.write(
                            ("data: " + json.dumps({"error": str(e)})
                             + "\n\n").encode())
                        self.wfile.flush()
                    except OSError:
                        pass

            def do_GET(self):
                if self.path == "/ready":
                    ok = runner.predictor.ready()
                    self._reply(200 if ok else 503, {"ready": ok})
                elif self.path == "/metrics":
                    self._reply_text(200, obs_metrics.REGISTRY.exposition())
                elif self.path == "/healthz":
                    health = runner.health()
                    self._reply(200 if health.get("status") == "ok"
                                else 503, health)
                elif self.path == "/debug/state":
                    self._reply(200, runner.debug_state())
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                handler = runner.routes.get(self.path)
                if handler is None:
                    self._reply(404, {"error": "not found"})
                    return
                parent = obs_trace.parse_traceparent(
                    self.headers.get("traceparent"))
                with obs_trace.span("serving.http", parent=parent,
                                    attrs={"path": self.path}) as sp:
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        request = json.loads(self.rfile.read(n) or b"{}")
                        resp = handler(request)
                        if isinstance(resp, SSEStream):
                            self._reply_stream(
                                resp, traceparent=sp.traceparent())
                        else:
                            self._reply(200, resp,
                                        traceparent=sp.traceparent())
                    except Overloaded as e:
                        # shed (or parked-unhealthy engine), not failed:
                        # 503 + Retry-After tells the client — and the
                        # gateway's failover — to go elsewhere
                        sp.set_attr("error", "overloaded")
                        self._reply(
                            503,
                            {"error": str(e),
                             "retry_after_s": e.retry_after_s},
                            traceparent=sp.traceparent(),
                            extra_headers={"Retry-After": max(
                                1, int(round(e.retry_after_s)))})
                    except Exception as e:
                        logger.exception("predict failed")
                        sp.set_attr("error", type(e).__name__)
                        self._reply(500, {"error": str(e)},
                                    traceparent=sp.traceparent())

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def health(self) -> dict:
        """Predictor ``health()`` when present, else readiness only."""
        fn = getattr(self.predictor, "health", None)
        if callable(fn):
            try:
                return fn()
            except Exception as e:  # health must answer, not raise
                return {"status": "error", "error": str(e)}
        ok = self.predictor.ready()
        return {"status": "ok" if ok else "not_ready"}

    def debug_state(self) -> dict:
        fn = getattr(self.predictor, "debug_state", None)
        if callable(fn):
            try:
                return fn()
            except Exception as e:
                return {"error": str(e)}
        return {"routes": sorted(self.routes),
                "predictor": type(self.predictor).__name__}

    def start(self) -> int:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        logger.info("inference runner listening on :%d", self.port)
        return self.port

    def run(self) -> None:
        self.start()
        self._thread.join()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
