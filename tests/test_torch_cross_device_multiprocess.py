"""The port's cross-device session across OS processes over TCP on
loopback: the device server and 2 devices as separate interpreters, one
device on the native C++ engine (the reference's MobileNN deployment
shape: a native device process talking to a Python aggregation server),
on the pattern of ``tests/test_cross_device_multiprocess.py``."""

import json
import os
import socket
import subprocess
import sys
import time

import pytest

from test_torch_comm import free_port_base

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_cross_device_worker.py")


def _wait_listening(port, timeout_s=120.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        with socket.socket() as sk:
            if sk.connect_ex(("127.0.0.1", port)) == 0:
                return
        time.sleep(0.1)
    raise TimeoutError(f"nothing listens on {port}")


def test_tcp_session_with_a_native_device_process(tmp_path):
    base = free_port_base(4)
    cache = str(tmp_path / "model_cache")
    os.makedirs(cache, exist_ok=True)
    out_path = str(tmp_path / "result.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    def spawn(role, rank, engine):
        return subprocess.Popen(
            [sys.executable, WORKER, role, str(rank), str(base), cache,
             engine, out_path], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    procs = [spawn("server", 0, "-")]
    try:
        _wait_listening(base)
        procs.append(spawn("device", 1, "native"))
        procs.append(spawn("device", 2, "-"))
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail("cross-device TCP session timed out")
            outs.append(out.decode(errors="replace"))
        for p, out in zip(procs, outs):
            assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    with open(out_path) as f:
        res = json.load(f)
    assert res["rounds"] == 2
    assert res["final_test_acc"] is not None and res["final_test_acc"] > 0.3
    accs = [a for a in res["device_eval_accs"] if a is not None]
    assert len(accs) == 2 and all(0.0 <= a <= 1.0 for a in accs)
    # the native engine ran in its own process, the other device on torch
    assert res["engines"] == {"1": "native", "2": "torch"}, res["engines"]
