"""Python API: ``fedml_tpu_torch.api.*`` — the programmatic platform
surface (counterpart of ``fedml_tpu/api``).

Parity target: ``api/__init__.py:29-43`` of the reference (``fedml_login``,
``launch_job``, ``run_status/run_logs/run_stop/run_list``, ``build``, model
serve). The reference's implementations are thin wrappers over a cloud
platform (MLOps REST + MQTT agents); this framework is **local-first by
design**: a job is a local subprocess, the "platform" is a run registry
under ``~/.cache/fedml_tpu_torch/runs/<run_id>/`` (``meta.json`` +
``job.log``; ``FEDML_TPU_RUNS_DIR`` moves it — the default is the port's own,
so the two packages' registries, allocation stores and monitors never act
on each other's runs),
and every API call works with zero network. The call shapes — launch
returns a run id, logs/status/stop address it — are kept so user code
written against the reference maps 1:1.

Job YAML forms accepted by :func:`launch_job`:

* **task job** (reference launch yaml): has a ``job:`` shell command and
  optionally ``workspace:`` — the command runs in the workspace;
* **training config** (reference fedml_config yaml): anything else — runs
  ``python -m fedml_tpu_torch.cli train --cf <yaml>`` so a
  simulation/cross-silo config is directly launchable. It trains on the
  card; ``launch_job(..., device="cpu")`` adds ``--device cpu``. Without a
  card and without it the job fails with the device error in its log.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shlex
import signal
import subprocess
import sys
import time
import uuid
import zipfile
from typing import Any, Dict, List, Optional

import yaml

logger = logging.getLogger(__name__)


def _runs_root() -> str:
    return os.path.expanduser(os.environ.get(
        "FEDML_TPU_RUNS_DIR", "~/.cache/fedml_tpu_torch/runs"))


# Run statuses (reference api/constants.py RunStatus, reduced to the
# lifecycle a local job actually has)
STATUS_RUNNING = "RUNNING"
STATUS_FINISHED = "FINISHED"
STATUS_FAILED = "FAILED"
STATUS_KILLED = "KILLED"


@dataclasses.dataclass
class LaunchResult:
    run_id: str
    result_code: int
    result_message: str
    inner_id: Optional[int] = None  # pid


def _run_dir(run_id: str) -> str:
    return os.path.join(_runs_root(), run_id)


def _write_meta(run_id: str, meta: Dict[str, Any]) -> None:
    # atomic: concurrent status pollers must never read truncated JSON
    path = os.path.join(_run_dir(run_id), "meta.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(tmp, path)


def _read_meta(run_id: str) -> Optional[Dict[str, Any]]:
    try:
        with open(os.path.join(_run_dir(run_id), "meta.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def fedml_login(api_key: Optional[str] = None) -> int:
    """Local-first stand-in for platform login: records the profile in the
    run registry so launches are attributed; never talks to a network.
    Returns 0 (success) for API-shape parity with the reference."""
    os.makedirs(_runs_root(), exist_ok=True)
    profile = os.path.join(_runs_root(), "profile.json")
    with open(profile, "w") as f:
        json.dump({"api_key_set": bool(api_key), "ts": time.time()}, f)
    return 0


def launch_job(yaml_file: str, api_key: Optional[str] = None,
               detach: bool = True, extra_env: Optional[Dict[str, str]] = None,
               device: Optional[str] = None) -> LaunchResult:
    """Launch a job described by ``yaml_file`` as a local subprocess. A
    training config's child gets ``--device <device>`` only when
    ``device`` is given (else it trains on the card)."""
    yaml_file = os.path.abspath(os.path.expanduser(yaml_file))
    if not os.path.exists(yaml_file):
        return LaunchResult("", -1, f"no such job yaml: {yaml_file}")
    with open(yaml_file) as f:
        spec = yaml.safe_load(f) or {}

    run_id = time.strftime("%Y%m%d-%H%M%S-") + uuid.uuid4().hex[:6]
    rdir = _run_dir(run_id)
    os.makedirs(rdir, exist_ok=True)

    # resource matching (reference scheduler_matcher.py consulted at
    # launch): a `computing: {device_slots: N}` section claims capacity
    # in the sqlite allocation store; no fit = the launch fails loudly
    device_id = None
    slots = int((spec.get("computing") or {}).get("device_slots", 0) or 0)
    if slots > 0:
        from .scheduler import default_db
        device_id = default_db().allocate(run_id, slots)
        if device_id is None:
            _write_meta(run_id, {
                "run_id": run_id, "yaml": yaml_file,
                "status": STATUS_FAILED,
                "error": f"no device with {slots} free slots"})
            return LaunchResult(
                run_id, -1, f"no device with {slots} free slots")

    if "job" in spec:  # task job: shell command in a workspace
        workspace = os.path.expanduser(str(spec.get("workspace", ".")))
        if not os.path.isabs(workspace):
            workspace = os.path.join(os.path.dirname(yaml_file), workspace)
        # record the exit code for run_status even when detached; the user
        # command runs in a subshell so its `exit` cannot skip the record
        wrapped = (f'( {spec["job"]} ); rc=$?; '
                   f'echo $rc > {shlex.quote(rdir)}/exit_code; exit $rc')
        cmd = ["bash", "-c", wrapped]
        kind = "task"
    else:  # training config: run through the CLI trainer
        workspace = os.path.dirname(yaml_file)
        inner = (f"{shlex.quote(sys.executable)} -m fedml_tpu_torch.cli "
                 f"train --cf {shlex.quote(yaml_file)}")
        if device is not None:
            inner += f" --device {shlex.quote(str(device))}"
        wrapped = (f'( {inner} ); rc=$?; echo $rc > {shlex.quote(rdir)}'
                   f'/exit_code; exit $rc')
        cmd = ["bash", "-c", wrapped]
        kind = "train"

    env = dict(os.environ)
    if kind == "train":
        # the subprocess must find this package even when it is run from a
        # source tree rather than installed
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = (pkg_root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else pkg_root)
    env["FEDML_TPU_RUN_ID"] = run_id
    env.update(extra_env or {})
    log_path = os.path.join(rdir, "job.log")
    try:
        with open(log_path, "ab") as log_f:
            proc = subprocess.Popen(cmd, cwd=workspace, env=env,
                                    stdout=log_f,
                                    stderr=subprocess.STDOUT,
                                    start_new_session=True)
    except OSError as e:  # e.g. workspace directory does not exist
        _release_allocation(run_id)
        _write_meta(run_id, {
            "run_id": run_id, "kind": kind, "yaml": yaml_file,
            "workspace": workspace, "pid": -1, "started": time.time(),
            "status": STATUS_FAILED, "error": str(e),
        })
        return LaunchResult(run_id, -1, f"could not start job: {e}")
    _write_meta(run_id, {
        "run_id": run_id, "kind": kind, "yaml": yaml_file,
        "cmd": " ".join(shlex.quote(c) for c in cmd),
        "workspace": workspace, "pid": proc.pid,
        "started": time.time(), "status": STATUS_RUNNING,
        **({"device": str(device)} if device is not None else {}),
        **({"device_id": device_id, "device_slots": slots}
           if device_id else {}),
    })
    # remote observability: ship this run's log to the configured log
    # server (reference mlops_runtime_log_daemon.py:333 tails + uploads)
    log_url = os.environ.get("FEDML_TPU_LOG_SERVER_URL")
    shipper = None
    if log_url:
        from ..core.mlops.log_daemon import start_log_shipper
        shipper = start_log_shipper(log_path, log_url, run_id=run_id)
    if not detach:
        rc = proc.wait()
        _finalize(run_id, rc)
        if shipper is not None:  # final flush, don't leak the poll thread
            shipper.stop()
        return LaunchResult(run_id, 0 if rc == 0 else -1,
                            f"exit code {rc}", proc.pid)
    return LaunchResult(run_id, 0, "launched", proc.pid)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


def _release_allocation(run_id: str) -> None:
    """Free the run's resource claim; cheap no-op when it holds none."""
    try:
        from .scheduler import default_db
        default_db().release(run_id)
    except Exception:  # the allocation store must never break run paths
        logger.exception("could not release allocation for %s", run_id)


def _finalize(run_id: str, rc: Optional[int]) -> None:
    meta = _read_meta(run_id) or {}
    meta["status"] = STATUS_FINISHED if rc == 0 else STATUS_FAILED
    meta["exit_code"] = rc
    meta["ended"] = time.time()
    _write_meta(run_id, meta)
    _release_allocation(run_id)


def _read_exit_code(run_id: str) -> Optional[int]:
    """The run's recorded exit code, or None when absent/unreadable. A
    recorded code is authoritative even if the pid has been recycled by
    an unrelated process (reboot/wraparound)."""
    rc_path = os.path.join(_run_dir(run_id), "exit_code")
    try:
        return int(open(rc_path).read().strip())
    except (OSError, ValueError):
        return None


def run_status(run_id: str) -> Optional[str]:
    """Current status; polls the pid for liveness and finalizes on exit."""
    meta = _read_meta(run_id)
    if meta is None:
        return None
    if meta.get("status") == STATUS_RUNNING:
        rc = _read_exit_code(run_id)
        if rc is None:
            pid = int(meta.get("pid", -1))
            if pid > 0 and _pid_alive(pid):
                return STATUS_RUNNING
            rc = -1  # process gone without recording a code
        _finalize(run_id, rc)
        meta = _read_meta(run_id)
    return meta.get("status")


def run_logs(run_id: str, tail: Optional[int] = None) -> List[str]:
    path = os.path.join(_run_dir(run_id), "job.log")
    if not os.path.exists(path):
        return []
    with open(path, errors="replace") as f:
        lines = f.read().splitlines()
    return lines[-tail:] if tail else lines


def run_stop(run_id: str) -> bool:
    # resolve liveness first so stopping an already-finished run does not
    # clobber its FINISHED/FAILED record
    status = run_status(run_id)
    if status is None:
        return False
    if status != STATUS_RUNNING:
        return True
    meta = _read_meta(run_id)
    pid = int(meta.get("pid", -1))
    if pid > 0 and _pid_alive(pid):
        try:  # kill the whole session (job may have children)
            os.killpg(os.getpgid(pid), signal.SIGTERM)
        except OSError:
            try:
                os.kill(pid, signal.SIGTERM)
            except OSError:
                pass
    meta["status"] = STATUS_KILLED
    meta["ended"] = time.time()
    _write_meta(run_id, meta)
    _release_allocation(run_id)
    return True


def run_wait(run_id: str, timeout_s: Optional[float] = None,
             poll_s: float = 0.5, kill_on_timeout: bool = True
             ) -> Optional[str]:
    """Job-monitor primitive (reference ``comm_utils/job_monitor.py`` role):
    block until the run reaches a terminal status; on timeout optionally
    stop the run. Returns the final status."""
    deadline = (time.time() + timeout_s) if timeout_s is not None else None
    while True:
        status = run_status(run_id)
        if status not in (STATUS_RUNNING,):
            return status
        if deadline is not None and time.time() > deadline:
            if kill_on_timeout:
                run_stop(run_id)
            return run_status(run_id)
        time.sleep(poll_s)


def run_list() -> List[Dict[str, Any]]:
    root = _runs_root()
    if not os.path.isdir(root):
        return []
    out = []
    for rid in sorted(os.listdir(root)):
        meta = _read_meta(rid)
        if meta:
            meta["status"] = run_status(rid)
            out.append(meta)
    return out


def build(source_dir: str, dest_zip: Optional[str] = None,
          config_yaml: Optional[str] = None) -> str:
    """Package a job workspace into a distributable zip (reference
    ``fedml build``): the workspace tree + the config under ``conf/``."""
    source_dir = os.path.abspath(os.path.expanduser(source_dir))
    dest_zip = dest_zip or (os.path.basename(source_dir.rstrip("/"))
                            + "_job.zip")
    dest_abs = os.path.abspath(dest_zip)
    with zipfile.ZipFile(dest_zip, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, _dirs, files in os.walk(source_dir):
            for fn in files:
                full = os.path.join(root, fn)
                if os.path.abspath(full) == dest_abs:
                    continue  # never zip the archive into itself
                zf.write(full, os.path.relpath(full, source_dir))
        if config_yaml:
            zf.write(os.path.abspath(os.path.expanduser(config_yaml)),
                     os.path.join("conf", os.path.basename(config_yaml)))
    return os.path.abspath(dest_zip)


def _input_shape(model: str, tree) -> Optional[tuple]:
    """One sample's shape where the artifact alone gives it: the linear
    models' first kernel is ``[in, out]`` (the JAX package's bytes)."""
    if model.lower() in ("lr", "logistic_regression", "mlp"):
        return (int(tree["Dense_0"]["kernel"].shape[0]),)
    return None


def model_serve(params_path: str, model: str, output_dim: int,
                port: int = 0, dataset: str = "", block: bool = False,
                device=None, input_shape=None, **model_args):
    """Serve a saved model artifact over HTTP on ``device`` (the card
    unless ``"cpu"``); returns the (started) runner. The CLI's ``serve``
    command and the reference's model-deploy flow both funnel here.

    torch sizes layers when it builds them, so the CNNs, LeNet, VGG and
    ResNet-18 need ``input_shape`` (one sample's, e.g. ``(32, 32, 3)``;
    without it the model hub raises a ``ValueError`` naming it); the
    linear models take it from the artifact, the ResNet-20/56 family needs
    none. ``model_args`` (e.g. ``precision``, ``fused_conv_block``) go into
    the model's :class:`~fedml_tpu_torch.arguments.Arguments`."""
    from ..arguments import Arguments
    from ..model import create
    from ..serving import (CheckpointPredictor, FedMLInferenceRunner,
                           load_model)

    args = Arguments(model=model, dataset=dataset or "synthetic_mnist",
                     **model_args)
    tree = load_model(params_path)
    if input_shape is None:
        input_shape = _input_shape(model, tree)
    predictor = CheckpointPredictor(create(args, output_dim, input_shape),
                                    tree, device=device)
    runner = FedMLInferenceRunner(predictor, port=port)
    if block:
        runner.run()
    else:
        runner.start()
    return runner
