"""The command tree (counterpart of ``fedml_tpu/cli/main.py``; reference
``cli/cli.py:11-77``), on ``argparse``: the standard library runs on every
host the port runs on.

The commands, options, output lines and exit codes are the JAX package's;
``train``, ``serve``, ``diagnosis``, ``launch`` and ``agent`` add
``--device`` (the card unless ``cpu``), and ``serve`` adds
``--input-shape``. :func:`main` takes the argument list and returns the
exit code, so callers (and tests) run a command in-process.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _out(msg: str) -> None:
    print(msg, flush=True)


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _wait_for_signal() -> None:
    """Block until SIGTERM or SIGINT (the daemons' foreground loop)."""
    import signal
    import threading
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()


def _parse_hostport(value: str, flag: str):
    host, _, port = value.partition(":")
    if not host or not port or not port.isdigit():
        _err(f"{flag} must be HOST:PORT, got {value!r}")
        return None
    return host, int(port)


def _login(ns) -> int:
    from .. import api
    rc = api.fedml_login(ns.api_key)
    _out("login OK" if rc == 0 else f"login failed ({rc})")
    return rc


def _launch(ns) -> int:
    from .. import api
    if ns.remote:
        if ns.device_id is None:
            _err("--remote requires --device-id")
            return 2
        addr = _parse_hostport(ns.remote, "--remote")
        if addr is None:
            return 2
        from ..agents import MasterAgent, launch_job_remote
        master = MasterAgent(*addr)
        master.start()
        try:
            info = launch_job_remote(ns.yaml_file, ns.device_id, master)
        finally:
            master.stop()
        _out(f"{info.get('run_id', '?')} {info['status']}")
        return 0 if info["status"] == "FINISHED" else 1
    res = api.launch_job(ns.yaml_file, detach=not ns.blocking,
                         device=ns.device)
    if res.result_code != 0:
        _err(f"launch failed: {res.result_message}")
        return 1
    _out(res.run_id)
    return 0


def _agent(ns) -> int:
    from ..agents import SlaveAgent
    addr = _parse_hostport(ns.broker, "--broker")
    if addr is None:
        return 2
    try:
        daemon = SlaveAgent(ns.device_id, *addr,
                            insecure_open=ns.insecure_open,
                            device=ns.device)
    except RuntimeError as e:
        _err(str(e))
        return 2
    daemon.start()
    # banner reflects the EFFECTIVE mode: with a secret in the env the
    # daemon authenticates even if --insecure-open was passed
    _out(f"agent {ns.device_id} bound to {ns.broker}"
         + (" [INSECURE-OPEN]" if daemon._secret is None else ""))
    _wait_for_signal()
    daemon.stop()
    return 0


def _broker(ns) -> int:
    import os
    import secrets as _secrets

    from ..core.distributed.communication.pubsub import (PubSubBroker,
                                                         broker_secret)
    if ns.insecure_open:
        # PubSubBroker(secret=None) falls back to the env secret, which
        # would silently re-arm auth under an "[INSECURE-OPEN]" banner —
        # drop it from this process so the flag means what it says
        os.environ.pop("FEDML_TPU_BROKER_SECRET", None)
        secret = None
    else:
        secret = broker_secret()
        if secret is None:
            token = _secrets.token_hex(16)
            secret = token.encode()
            _out("no FEDML_TPU_BROKER_SECRET configured — generated one "
                 f"for this broker:\n  {token}\nexport it as "
                 "FEDML_TPU_BROKER_SECRET on every peer.")
    b = PubSubBroker(port=ns.port, secret=secret)
    _out(f"broker listening on :{b.port}"
         + (" [INSECURE-OPEN]" if b.secret is None else ""))
    _wait_for_signal()
    b.stop()
    return 0


def _monitor(ns) -> int:
    from ..api.scheduler import JobMonitor
    mon = JobMonitor(interval_s=ns.interval,
                     max_restarts=ns.max_restarts).start()
    _out(f"job monitor running (interval {ns.interval}s, "
         f"max_restarts {ns.max_restarts})")
    _wait_for_signal()
    mon.stop()
    return 0


def _device_bind(ns) -> int:
    from ..agents.accounts import AccountRegistry
    did, token = AccountRegistry().register_device(ns.api_key,
                                                  device_id=ns.device_id)
    _out(f"device_id: {did}")
    _out(f"device_token: {token}")
    _out("export FEDML_TPU_DEVICE_TOKEN on the agent host; the token is "
         "not stored and cannot be shown again.")
    return 0


def _device_list(ns) -> int:
    from ..agents.accounts import AccountRegistry
    for d in AccountRegistry().devices():
        _out(f"{d['device_id']}  account={d['account_id']} "
             f"revoked={d['revoked']} version={d['version'] or '-'}")
    return 0


def _device_revoke(ns) -> int:
    from ..agents.accounts import AccountRegistry
    ok = AccountRegistry().revoke_device(ns.device_id)
    _out("revoked" if ok else "unknown device")
    return 0 if ok else 1


def _run_list(ns) -> int:
    from .. import api
    for meta in api.run_list():
        _out(f"{meta['run_id']}  {meta.get('status'):<9} "
             f"{meta.get('kind', '?'):<6} {meta.get('yaml', '')}")
    return 0


def _run_status(ns) -> int:
    from .. import api
    status = api.run_status(ns.run_id)
    if status is None:
        _err("unknown run")
        return 1
    _out(status)
    return 0


def _run_logs(ns) -> int:
    from .. import api
    for line in api.run_logs(ns.run_id, tail=ns.tail):
        _out(line)
    return 0


def _run_stop(ns) -> int:
    from .. import api
    ok = api.run_stop(ns.run_id)
    _out("stopped" if ok else "unknown run")
    return 0 if ok else 1


def _build(ns) -> int:
    from .. import api
    _out(api.build(ns.source_dir, ns.dest, ns.config))
    return 0


def _train(ns) -> int:
    """Run a training config in-process on ``--device`` (the card unless
    ``cpu``)."""
    import fedml_tpu_torch

    from ..arguments import load_arguments
    from ..constants import (FEDML_TRAINING_PLATFORM_CROSS_CLOUD,
                             FEDML_TRAINING_PLATFORM_CROSS_SILO)
    from ..device import get_device
    try:
        device = get_device(ns.device)
    except (RuntimeError, ValueError) as e:
        _err(f"train: {e}")
        return 1
    args = load_arguments(ns.yaml_file, rank=ns.rank,
                          **({"role": ns.role} if ns.role else {}))
    ttype = str(getattr(args, "training_type", "simulation"))
    if ttype in (FEDML_TRAINING_PLATFORM_CROSS_SILO,
                 FEDML_TRAINING_PLATFORM_CROSS_CLOUD):
        if str(getattr(args, "role", "client")) == "server":
            result = fedml_tpu_torch.run_cross_silo_server(args,
                                                           device=device)
        else:
            result = fedml_tpu_torch.run_cross_silo_client(args,
                                                           device=device)
    else:
        result = fedml_tpu_torch.run_simulation(
            backend=str(getattr(args, "backend", "gpu")), args=args,
            device=device)
    if isinstance(result, dict):
        summary = {k: result[k] for k in
                   ("final_test_acc", "final_test_loss", "rounds",
                    "wall_time_s") if k in result}
        _out(json.dumps(summary))
    return 0


def _shape(value: str):
    try:
        return tuple(int(d) for d in value.split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--input-shape takes comma-separated ints (e.g. 32,32,3), "
            f"got {value!r}") from None


def _serve(ns) -> int:
    from .. import api
    _out(f"serving {ns.params_path} on :{ns.port} (POST /predict)")
    try:
        api.model_serve(ns.params_path, ns.model, ns.output_dim,
                        port=ns.port, dataset=ns.dataset, block=True,
                        device=ns.device, input_shape=ns.input_shape)
    except (RuntimeError, ValueError) as e:  # no card; no input shape
        _err(f"serve: {e}")
        return 1
    return 0


def _env(ns) -> int:
    from ..utils.collect_env import collect_env
    _out(collect_env())
    return 0


def _diagnosis(ns) -> int:
    from ..utils.diagnosis import run_diagnosis
    report = run_diagnosis(device=ns.device)
    for name, (ok, detail) in report.items():
        _out(f"{name:<10} {'OK' if ok else 'FAIL'}  {detail}")
    return 0 if all(ok for ok, _ in report.values()) else 1


def _version(ns) -> int:
    import fedml_tpu_torch
    _out(f"fedml_tpu_torch version: {fedml_tpu_torch.__version__}")
    return 0


_DEVICE_HELP = "torch device (default: the card; 'cpu' for the CPU)"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fedml_tpu_torch",
        description="fedml_tpu_torch — the PyTorch/CUDA port of fedml_tpu")
    sub = p.add_subparsers(dest="command", metavar="COMMAND")
    sub.required = True

    c = sub.add_parser("login", help="Record a local platform profile "
                                     "(local-first; no network)")
    c.add_argument("api_key", nargs="?", default=None)
    c.set_defaults(fn=_login)

    c = sub.add_parser("launch", help="Launch a job yaml (task job or "
                                      "training config) as a local run, or "
                                      "dispatch it to a remote agent over "
                                      "the broker with --remote")
    c.add_argument("yaml_file")
    c.add_argument("--blocking", action="store_true",
                   help="wait for the job instead of detaching")
    c.add_argument("--remote", default=None, metavar="HOST:PORT",
                   help="dispatch via the pub/sub broker to an agent daemon")
    c.add_argument("--device-id", type=int, default=None,
                   help="target agent device id (required with --remote)")
    c.add_argument("--device", default=None,
                   help=f"a local training config's {_DEVICE_HELP}")
    c.set_defaults(fn=_launch)

    c = sub.add_parser("agent", help="Run the compute-agent daemon: binds "
                                     "to the broker, executes start-train "
                                     "commands, streams status back "
                                     "(reference slave agent)")
    c.add_argument("--broker", required=True, metavar="HOST:PORT")
    c.add_argument("--device-id", type=int, required=True)
    c.add_argument("--insecure-open", action="store_true",
                   help="accept UNAUTHENTICATED job dispatch (no bind "
                        "token); without this flag the daemon refuses to "
                        "start unless FEDML_TPU_AGENT_SECRET is set")
    c.add_argument("--device", default=None,
                   help=f"the training jobs' {_DEVICE_HELP}")
    c.set_defaults(fn=_agent)

    c = sub.add_parser("broker", help="Run a standalone pub/sub broker (the "
                                      "MQTT analogue agents and launch "
                                      "--remote bind to)")
    c.add_argument("--port", type=int, default=0,
                   help="0 = pick a free port")
    c.add_argument("--insecure-open", action="store_true",
                   help="skip connection authentication; without this flag "
                        "a secret is taken from FEDML_TPU_BROKER_SECRET or "
                        "GENERATED and printed once at startup")
    c.set_defaults(fn=_broker)

    c = sub.add_parser("monitor", help="Run the job monitor daemon: detects "
                                       "runs whose process died without an "
                                       "exit record, releases their "
                                       "resource allocations, and restarts "
                                       "jobs that opted in (restart: true)")
    c.add_argument("--interval", type=float, default=2.0,
                   help="seconds between registry scans")
    c.add_argument("--max-restarts", type=int, default=3,
                   help="restart cap per job lineage")
    c.set_defaults(fn=_monitor)

    c = sub.add_parser("device", help="Device-binding account registry "
                                      "(enroll, list, revoke)")
    dsub = c.add_subparsers(dest="device_command", metavar="COMMAND")
    dsub.required = True
    d = dsub.add_parser("bind", help="Enroll a device under the API key's "
                                     "account; prints the device id and its "
                                     "ONE-TIME token (export as "
                                     "FEDML_TPU_DEVICE_TOKEN on the agent)")
    d.add_argument("api_key")
    d.add_argument("--device-id", default=None, help="explicit device id")
    d.set_defaults(fn=_device_bind)
    d = dsub.add_parser("list", help="List enrolled devices")
    d.set_defaults(fn=_device_list)
    d = dsub.add_parser("revoke", help="Revoke a device's enrollment")
    d.add_argument("device_id")
    d.set_defaults(fn=_device_revoke)

    c = sub.add_parser("run", help="Inspect and control runs")
    rsub = c.add_subparsers(dest="run_command", metavar="COMMAND")
    rsub.required = True
    r = rsub.add_parser("list", help="List runs")
    r.set_defaults(fn=_run_list)
    r = rsub.add_parser("status", help="A run's status")
    r.add_argument("run_id")
    r.set_defaults(fn=_run_status)
    r = rsub.add_parser("logs", help="A run's log")
    r.add_argument("run_id")
    r.add_argument("--tail", type=int, default=None,
                   help="last N lines only")
    r.set_defaults(fn=_run_logs)
    r = rsub.add_parser("stop", help="Stop a run")
    r.add_argument("run_id")
    r.set_defaults(fn=_run_stop)

    c = sub.add_parser("build", help="Package a job workspace into a zip")
    c.add_argument("source_dir")
    c.add_argument("--dest", default=None, help="output zip path")
    c.add_argument("--config", default=None, help="config yaml to embed")
    c.set_defaults(fn=_build)

    c = sub.add_parser("train", help="Run a training config yaml "
                                     "in-process")
    c.add_argument("--cf", dest="yaml_file", required=True,
                   help="config yaml")
    c.add_argument("--rank", type=int, default=0)
    c.add_argument("--role", default=None)
    c.add_argument("--device", default=None, help=_DEVICE_HELP)
    c.set_defaults(fn=_train)

    c = sub.add_parser("serve", help="Serve a saved model artifact over "
                                     "HTTP")
    c.add_argument("params_path")
    c.add_argument("--model", required=True,
                   help="model name (e.g. resnet20)")
    c.add_argument("--output-dim", type=int, required=True)
    c.add_argument("--port", type=int, default=8890)
    c.add_argument("--dataset", default="",
                   help="dataset name (shapes some model variants)")
    c.add_argument("--device", default=None, help=_DEVICE_HELP)
    c.add_argument("--input-shape", type=_shape, default=None,
                   help="one sample's shape, e.g. 32,32,3 (the CNNs, "
                        "LeNet, VGG and ResNet-18 need it)")
    c.set_defaults(fn=_serve)

    c = sub.add_parser("env", help="Print environment info (versions, "
                                   "devices)")
    c.set_defaults(fn=_env)

    c = sub.add_parser("diagnosis", help="Check local comm backends "
                                         "end-to-end")
    c.add_argument("--device", default=None, help=_DEVICE_HELP)
    c.set_defaults(fn=_diagnosis)

    c = sub.add_parser("version", help="Display fedml_tpu_torch version")
    c.set_defaults(fn=_version)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    """Run one command; returns its exit code (argparse's usage errors
    and ``--help`` return theirs instead of exiting)."""
    try:
        ns = build_parser().parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    return int(ns.fn(ns) or 0)


if __name__ == "__main__":
    sys.exit(main())
