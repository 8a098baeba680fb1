"""Subprocess replica entrypoint (counterpart of
``fedml_tpu/serving/replica_main.py``): ``python -m
fedml_tpu_torch.serving.replica_main <spec.json>`` builds a predictor from
a model artifact and serves it over HTTP until terminated.

This is the process-isolation analogue of a per-replica container: a
replica crash — up to ``kill -9`` — takes down this process only, never
the gateway or its siblings; the replica set's health check replaces the
corpse. Each replica on the card holds its own CUDA context, and its
memory comes back when the process is reaped.

Spec schema (JSON):
  ``args``        flat config dict (model fields the bundle needs, the
                  ``serving_*`` / ``chaos_serving_*`` / ``obs_*`` knobs)
  ``params_path`` msgpack model artifact (``serving.save_model``)
  ``kind``        ``"causal_lm"`` (the LLM template, chat route mounted)
                  or ``"classifier"`` (:class:`CheckpointPredictor`)
  ``output_dim``  classifier width
  ``input_shape`` the classifier's input shape (the linear models need it)
  ``port_file``   where to write the bound port (the parent polls it)
  ``device``      ``"cuda"`` (the default) or ``"cpu"``; a replica asked
                  for the card on a host without one exits with an error,
                  it never serves from the CPU instead
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
from types import SimpleNamespace


def main() -> None:
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    from ..core import mlops, obs
    from ..core.chaos import ServingChaosInjector
    from ..device import get_device
    from . import CheckpointPredictor, FedMLInferenceRunner

    # raises before anything is served when the card is asked for and absent
    device = get_device(spec.get("device", "cuda"))
    args = SimpleNamespace(**spec["args"])
    # a replica is a first-class observability citizen: its own JSONL
    # file (run_<id>.jsonl; the pid-suffixed run_id keeps sibling
    # replicas' files apart) and the obs knobs, from the spec's flat
    # config
    args.run_id = f"{getattr(args, 'run_id', '0')}_replica{os.getpid()}"
    mlops.init(args, device=device)
    # serving chaos in a SUBPROCESS replica is allowed to be lethal:
    # crash-at-request-N exits this process for real (the gateway's
    # health-aware failover + the set's health check are what recover)
    chaos = ServingChaosInjector.from_args(args, hard_crash=True)
    # graceful SIGTERM drain (the drain-before-kill scale-down path):
    # stop accepting, let the engine finish, then exit 0 — so a
    # scale-down victim's in-flight work resolves instead of dying
    # mid-stream. SIGKILL remains the crash path chaos exercises. The
    # engine's flight dump chains in front of it (installed after it).
    stop_evt = threading.Event()
    signal.signal(signal.SIGTERM, lambda _sig, _frm: stop_evt.set())
    if spec.get("kind") == "causal_lm":
        from .llm_template import CausalLMPredictor, ChatCompletionRunner
        predictor = CausalLMPredictor.from_artifact(
            args, spec["params_path"], device=device)
        runner = ChatCompletionRunner(predictor, chaos=chaos)
        if predictor.engine is not None:
            obs.flight.install_signal_dump(
                predictor.engine.flight, predictor.engine._flight_path)
    else:
        shape = spec.get("input_shape")
        predictor = CheckpointPredictor.from_files(
            args, spec["params_path"], int(spec["output_dim"]),
            input_shape=None if shape is None else tuple(shape),
            device=device)
        runner = FedMLInferenceRunner(predictor, chaos=chaos)
    port = runner.start()
    port_file = spec.get("port_file")
    if port_file:
        tmp = f"{port_file}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(str(port))
        os.replace(tmp, port_file)
    while not stop_evt.wait(0.5):
        if not runner._thread.is_alive():
            return
    close = getattr(predictor, "close", None)
    if callable(close):
        try:
            close()   # engine stop: drains the loop + flushes metrics
        except Exception:  # noqa: BLE001 — exiting either way
            pass
    runner.stop()


if __name__ == "__main__":
    main()
