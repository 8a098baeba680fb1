"""The port's platform layer: ``fedml_tpu_torch.api``, ``cli``,
``workflow``, ``utils.collect_env`` and ``utils.diagnosis``.

The cases of ``tests/test_platform.py`` on the port (the run registry in
``FEDML_TPU_RUNS_DIR`` under ``tmp_path``, every job that trains or serves
on ``device="cpu"`` / ``--device cpu``, diagnosis on free ports), the
refusals on a host with no card, and parity with the JAX package: one
training yaml through both packages' CLI trainers (params within the house
tolerance ``rtol=2e-4, atol=2e-5``), one artifact served by both (outputs
within the same tolerance), one workflow DAG with a failing node through
both (equal outputs and statuses).
"""

import json
import os
import random
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from fedml_tpu_torch import api
from fedml_tpu_torch.cli import main as cli_main

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_CARD = "no CUDA device is available"


@pytest.fixture()
def runs_dir(tmp_path, monkeypatch):
    d = tmp_path / "runs"
    monkeypatch.setenv("FEDML_TPU_RUNS_DIR", str(d))
    return d


def _wait_status(run_id, want, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        status = api.run_status(run_id)
        if status in want:
            return status
        time.sleep(0.3)
    return api.run_status(run_id)


def _free_port_pair() -> int:
    """A base port with ``base`` and ``base + 1`` free on loopback (an
    echo binds rank 0 and rank 1), never the fixed diagnosis ports the
    JAX suite binds."""
    rng = random.Random()
    for _ in range(200):
        base = rng.randint(20000, 60000)
        socks = []
        try:
            for p in (base, base + 1):
                sk = socket.socket()
                socks.append(sk)
                sk.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for sk in socks:
                sk.close()
    raise RuntimeError("no free port pair")


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.load(r)


TRAIN_YAML = """
common_args:
  training_type: simulation
  random_seed: 0
data_args:
  dataset: synthetic_mnist
train_args:
  client_num_in_total: 4
  client_num_per_round: 4
  comm_round: 2
  epochs: 1
  batch_size: 16
  learning_rate: 0.1
model_args:
  model: lr
tracking_args:
  save_model_path: {ckpt}
"""


class TestApi:
    def test_task_job_lifecycle(self, runs_dir, tmp_path):
        job = tmp_path / "job.yaml"
        job.write_text("workspace: .\njob: echo hello-from-job; exit 0\n")
        assert api.fedml_login("k") == 0
        res = api.launch_job(str(job))
        assert res.result_code == 0 and res.run_id
        status = _wait_status(res.run_id, {api.STATUS_FINISHED,
                                           api.STATUS_FAILED})
        assert status == api.STATUS_FINISHED
        assert any("hello-from-job" in l for l in api.run_logs(res.run_id))
        # stopping a finished run must NOT clobber its record
        assert api.run_stop(res.run_id)
        assert api.run_status(res.run_id) == api.STATUS_FINISHED
        assert any(m["run_id"] == res.run_id for m in api.run_list())

    def test_failed_job_status(self, runs_dir, tmp_path):
        job = tmp_path / "job.yaml"
        job.write_text("job: exit 3\n")
        res = api.launch_job(str(job), detach=False)
        assert res.result_code == -1
        assert api.run_status(res.run_id) == api.STATUS_FAILED

    def test_stop_running_job(self, runs_dir, tmp_path):
        job = tmp_path / "job.yaml"
        job.write_text("job: sleep 60\n")
        res = api.launch_job(str(job))
        assert api.run_status(res.run_id) == api.STATUS_RUNNING
        assert api.run_stop(res.run_id)
        assert api.run_status(res.run_id) == api.STATUS_KILLED

    def test_build_packages_workspace(self, tmp_path):
        src = tmp_path / "ws"
        src.mkdir()
        (src / "main.py").write_text("print('hi')\n")
        cfg = tmp_path / "conf.yaml"
        cfg.write_text("a: 1\n")
        dest = api.build(str(src), str(tmp_path / "out.zip"), str(cfg))
        import zipfile
        names = zipfile.ZipFile(dest).namelist()
        assert "main.py" in names
        assert "conf/conf.yaml" in names

    def test_default_runs_root_is_the_ports_own(self, monkeypatch):
        """The two packages' registries never act on each other's runs."""
        monkeypatch.delenv("FEDML_TPU_RUNS_DIR", raising=False)
        assert api._runs_root() == os.path.expanduser(
            "~/.cache/fedml_tpu_torch/runs")


class TestCliTrainAndServe:
    def test_cli_runs_sim_from_yaml_and_model_serves(self, runs_dir,
                                                     tmp_path):
        """The full platform slice: yaml -> CLI train subprocess ->
        checkpointed params -> HTTP serving, on the CPU by request."""
        ckpt = tmp_path / "model.pkl"
        cfg = tmp_path / "fedml_config.yaml"
        cfg.write_text(TRAIN_YAML.format(ckpt=ckpt))
        res = api.launch_job(str(cfg), detach=False, device="cpu")
        logs = "\n".join(api.run_logs(res.run_id))
        assert res.result_code == 0, logs
        assert api.run_status(res.run_id) == api.STATUS_FINISHED
        assert ckpt.exists(), logs
        meta = api._read_meta(res.run_id)
        assert " --device cpu" in meta["cmd"] and meta["device"] == "cpu"

        # lr's input shape comes from the artifact's first kernel
        runner = api.model_serve(str(ckpt), model="lr", output_dim=10,
                                 device="cpu")
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{runner.port}/ready") as r:
                assert json.load(r)["ready"] is True
            x = np.zeros((2, 784), np.float32).tolist()
            out = _post(runner.port, "/predict", {"inputs": x})
            assert len(out["classes"]) == 2
            assert len(out["outputs"][0]) == 10
        finally:
            runner.stop()

    def test_cli_version_env(self, capsys):
        assert cli_main(["version"]) == 0
        assert "fedml_tpu_torch version" in capsys.readouterr().out
        assert cli_main(["env"]) == 0
        out = capsys.readouterr().out
        assert "torch:" in out and "cuda devices:" in out


class TestNoCard:
    """A host with no card runs nothing on the CPU unless asked: each
    entry point fails naming the missing CUDA device."""

    def test_cli_train_without_device_fails_naming_cuda(self, tmp_path,
                                                        capsys):
        if torch.cuda.is_available():
            pytest.skip("this host has a card")
        cfg = tmp_path / "c.yaml"
        cfg.write_text(TRAIN_YAML.format(ckpt=tmp_path / "m.fmtpu"))
        assert cli_main(["train", "--cf", str(cfg)]) == 1
        assert NO_CARD in capsys.readouterr().err
        assert not (tmp_path / "m.fmtpu").exists()

    def test_launch_job_without_device_fails_in_its_log(self, runs_dir,
                                                        tmp_path):
        if torch.cuda.is_available():
            pytest.skip("this host has a card")
        cfg = tmp_path / "c.yaml"
        cfg.write_text(TRAIN_YAML.format(ckpt=tmp_path / "m.fmtpu"))
        res = api.launch_job(str(cfg), detach=False)
        assert res.result_code == -1
        assert api.run_status(res.run_id) == api.STATUS_FAILED
        assert any(NO_CARD in l for l in api.run_logs(res.run_id))
        assert "--device" not in api._read_meta(res.run_id)["cmd"]

    def test_serve_and_diagnosis_without_device(self, tmp_path, capsys):
        if torch.cuda.is_available():
            pytest.skip("this host has a card")
        from fedml_tpu_torch.serving import save_model
        from fedml_tpu_torch.utils.diagnosis import _probe_device
        path = save_model({"Dense_0.weight": torch.zeros(10, 784),
                           "Dense_0.bias": torch.zeros(10)},
                          str(tmp_path / "m.fmtpu"))
        with pytest.raises(RuntimeError, match=NO_CARD):
            api.model_serve(path, "lr", 10)
        assert cli_main(["serve", path, "--model", "lr", "--output-dim",
                         "10", "--port", "0"]) == 1
        assert NO_CARD in capsys.readouterr().err
        ok, detail = _probe_device(None)
        assert not ok and NO_CARD in detail


class TestModelServeShapes:
    def test_input_shape_rules(self, tmp_path):
        """The linear models read their input width from the artifact; a
        CNN without ``input_shape`` raises naming it; the ResNets need
        none; the CLI parses ``--input-shape``."""
        from fedml_tpu_torch.arguments import Arguments
        from fedml_tpu_torch.cli.main import _shape
        from fedml_tpu_torch.model import create
        from fedml_tpu_torch.serving import save_model
        mlp = create(Arguments(model="mlp"), 10, (12,))
        path = save_model({k: v.detach() for k, v in
                           mlp.module.state_dict().items()},
                          str(tmp_path / "mlp.fmtpu"))
        runner = api.model_serve(path, "mlp", 10, device="cpu")
        try:
            out = _post(runner.port, "/predict",
                        {"inputs": np.ones((3, 12), np.float32).tolist()})
            assert np.asarray(out["outputs"]).shape == (3, 10)
        finally:
            runner.stop()
        with pytest.raises(ValueError, match="input_shape"):
            api.model_serve(path, "cnn", 10, device="cpu")
        r20 = create(Arguments(model="resnet20"), 10)
        rpath = save_model({k: v.detach() for k, v in
                            r20.module.state_dict().items()},
                           str(tmp_path / "r20.fmtpu"))
        runner = api.model_serve(rpath, "resnet20", 10, device="cpu")
        runner.stop()
        assert _shape("32,32,3") == (32, 32, 3)


class TestWorkflow:
    def test_dag_order_and_outputs(self):
        from fedml_tpu_torch.workflow import CallableJob, Workflow
        wf = Workflow("t", max_workers=2)
        a = wf.add_job(CallableJob("a", lambda: 1))
        b = wf.add_job(CallableJob("b", lambda inp: inp["a"] + 1), [a])
        c = wf.add_job(CallableJob("c", lambda inp: inp["b"] * 10), [b])
        out = wf.run()
        assert out == {"a": 1, "b": 2, "c": 20}

    def test_failure_cancels_dependents(self):
        from fedml_tpu_torch.workflow import CallableJob, JobStatus, Workflow
        wf = Workflow("t")

        def boom():
            raise RuntimeError("boom")

        a = wf.add_job(CallableJob("a", boom))
        b = wf.add_job(CallableJob("b", lambda inp: 1), [a])
        with pytest.raises(RuntimeError, match="1 job"):
            wf.run()
        assert wf.jobs["a"].status == JobStatus.FAILED
        assert wf.jobs["b"].status == JobStatus.CANCELLED

    def test_cycle_detection(self):
        from fedml_tpu_torch.workflow import CallableJob, Workflow
        wf = Workflow("t")
        a = wf.add_job(CallableJob("a", lambda: 1))
        b = wf.add_job(CallableJob("b", lambda: 2), [a])
        a.dependencies = [b]  # force a cycle
        with pytest.raises(ValueError, match="cyclic"):
            wf.run()

    def test_launch_job_in_workflow(self, runs_dir, tmp_path):
        from fedml_tpu_torch.workflow import CallableJob, LaunchJob, Workflow
        job = tmp_path / "job.yaml"
        job.write_text("job: echo wf-step-done\n")
        wf = Workflow("launcher")
        a = wf.add_job(LaunchJob("train", str(job)))
        b = wf.add_job(
            CallableJob("check",
                        lambda inp: any("wf-step-done" in l
                                        for l in inp["train"]["logs"])),
            [a])
        out = wf.run()
        assert out["check"] is True


class TestDiagnosis:
    def test_diagnosis_all_ok(self):
        from fedml_tpu_torch.utils.diagnosis import run_diagnosis
        base = _free_port_pair()
        report = run_diagnosis(device="cpu", grpc_port=base,
                               tcp_port=_free_port_pair())
        assert set(report) == {"device", "grpc", "tcp"}
        for name, (ok, detail) in report.items():
            assert ok, f"{name}: {detail}"


def test_run_wait_timeout_kills(runs_dir, tmp_path):
    """Job-monitor: a hung job is stopped when the wait deadline passes."""
    job = tmp_path / "job.yaml"
    job.write_text("job: sleep 120\n")
    res = api.launch_job(str(job))
    status = api.run_wait(res.run_id, timeout_s=2.0)
    assert status == api.STATUS_KILLED


def test_run_wait_returns_finished(runs_dir, tmp_path):
    job = tmp_path / "job.yaml"
    job.write_text("job: echo done\n")
    res = api.launch_job(str(job))
    assert api.run_wait(res.run_id, timeout_s=30.0) == api.STATUS_FINISHED


def test_cli_imports_neither_click_nor_jax():
    """The CLI, api and agents stand on the standard library and torch."""
    probe = ("import sys\nimport fedml_tpu_torch.cli, fedml_tpu_torch.api, "
             "fedml_tpu_torch.agents, fedml_tpu_torch.workflow\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('click', 'jax', 'fedml_tpu')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ROOT},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# -- parity with the JAX package ---------------------------------------------


# The port's ``cli train`` from given params: argv[1] is a ``save_model``
# artifact handed to ``run_simulation`` as ``init_params``; the rest is the
# CLI's argv.
PORT_TRAIN_FROM = """
import sys
import fedml_tpu_torch
from fedml_tpu_torch.cli import main
from fedml_tpu_torch.interop import flax_to_state_dict
from fedml_tpu_torch.serving import load_model
init = flax_to_state_dict(load_model(sys.argv[1]))
run_simulation = fedml_tpu_torch.run_simulation
fedml_tpu_torch.run_simulation = (
    lambda *a, **k: run_simulation(*a, init_params=init, **k))
sys.exit(main(sys.argv[2:]))
"""


@pytest.fixture(scope="module")
def trained_pair(tmp_path_factory):
    """One lr / synthetic_mnist yaml trained by ``python -m fedml_tpu.cli
    train`` (through the JAX package's ``api.launch_job``) and by the
    port's ``cli train --device cpu`` in a process of its own, both from
    the JAX package's seeded init: ``PORT_TRAIN_FROM`` hands the port's
    ``run_simulation`` those params (the port's own init is a
    ``torch.Generator``'s, not flax's)."""
    import jax

    import fedml_tpu
    import fedml_tpu.data
    import fedml_tpu.model
    from fedml_tpu import api as japi
    from fedml_tpu.arguments import Arguments as JArguments
    from fedml_tpu.serving import save_model as j_save_model

    d = tmp_path_factory.mktemp("cli_parity")
    old = os.environ.get("FEDML_TPU_RUNS_DIR")
    os.environ["FEDML_TPU_RUNS_DIR"] = str(d / "runs")
    try:
        cfg = dict(dataset="synthetic_mnist", model="lr", random_seed=0,
                   client_num_in_total=4, client_num_per_round=4,
                   comm_round=2, batch_size=16, learning_rate=0.1)
        jargs = JArguments(backend="tpu", **cfg)
        fed, out_dim = fedml_tpu.data.load(jargs)
        key = jax.random.split(jax.random.PRNGKey(0))[0]
        p0 = jax.device_get(fedml_tpu.model.create(jargs, out_dim).init(
            key, fed.train.x[0, 0]))
        init = j_save_model(p0, str(d / "init.fmtpu"))
        yml = d / "job.yaml"
        yml.write_text(TRAIN_YAML.format(ckpt=d / "model.fmtpu"))
        rj = japi.launch_job(str(yml), detach=False)
        assert rj.result_code == 0, "\n".join(japi.run_logs(rj.run_id))
        os.replace(d / "model.fmtpu", d / "jax.fmtpu")
        rt = subprocess.run(
            [sys.executable, "-c", PORT_TRAIN_FROM, init, "train", "--cf",
             str(yml), "--device", "cpu"], cwd=ROOT,
            env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True,
            text=True, timeout=300)
        assert rt.returncode == 0, rt.stdout + rt.stderr
        os.replace(d / "model.fmtpu", d / "port.fmtpu")
        yield {"jax": str(d / "jax.fmtpu"), "port": str(d / "port.fmtpu"),
               "init": p0, "jax_log": japi.run_logs(rj.run_id),
               "port_log": rt.stdout.splitlines()}
    finally:
        if old is None:
            os.environ.pop("FEDML_TPU_RUNS_DIR", None)
        else:
            os.environ["FEDML_TPU_RUNS_DIR"] = old


def test_cli_train_matches_jax(trained_pair):
    from fedml_tpu_torch.serving import load_model
    got = load_model(trained_pair["port"])
    want = load_model(trained_pair["jax"])
    p0 = trained_pair["init"]
    assert set(got) == set(want) == {"Dense_0"}
    for name in ("kernel", "bias"):
        np.testing.assert_allclose(got["Dense_0"][name],
                                   want["Dense_0"][name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    # the runs trained: the params moved away from the shared init
    assert float(np.abs(want["Dense_0"]["kernel"]
                        - np.asarray(p0["Dense_0"]["kernel"])).max()) > 1e-3
    # both printed the CLI's summary line with the same keys and rounds
    sj, st = (json.loads(log[-1]) for log in
              (trained_pair["jax_log"], trained_pair["port_log"]))
    assert set(sj) == set(st) and sj["rounds"] == st["rounds"] == 2
    np.testing.assert_allclose(st["final_test_loss"], sj["final_test_loss"],
                               rtol=RTOL, atol=ATOL)


def test_model_serve_matches_jax(trained_pair):
    from fedml_tpu import api as japi
    x = np.random.RandomState(5).rand(4, 784).astype(np.float32).tolist()
    jr = japi.model_serve(trained_pair["jax"], model="lr", output_dim=10)
    tr = api.model_serve(trained_pair["jax"], model="lr", output_dim=10,
                         device="cpu")
    try:
        want = _post(jr.port, "/predict", {"inputs": x})
        got = _post(tr.port, "/predict", {"inputs": x})
    finally:
        jr.stop()
        tr.stop()
    np.testing.assert_allclose(got["outputs"], want["outputs"], rtol=RTOL,
                               atol=ATOL)
    assert got["classes"] == np.argmax(got["outputs"], -1).tolist()


def test_workflow_matches_jax():
    """The same DAG (a chain, a failing node and its dependent, an
    independent node) gives equal outputs, statuses and error in both."""
    import fedml_tpu.workflow as jwf
    import fedml_tpu_torch.workflow as twf

    def boom():
        raise RuntimeError("boom")

    def run(mod):
        wf = mod.Workflow("parity", max_workers=3)
        a = wf.add_job(mod.CallableJob("a", lambda: 3))
        b = wf.add_job(mod.CallableJob("b", lambda inp: inp["a"] * 7), [a])
        wf.add_job(mod.CallableJob("c", lambda inp: [inp["b"], "x"]), [b])
        f = wf.add_job(mod.CallableJob("fail", boom))
        wf.add_job(mod.CallableJob("after_fail", lambda inp: 1), [f, a])
        wf.add_job(mod.CallableJob("free", lambda: {"k": 1}))
        with pytest.raises(RuntimeError) as e:
            wf.run()
        return wf.outputs, wf.status(), str(e.value)

    assert run(twf) == run(jwf)


def test_diagnosis_without_grpcio_reports_grpc_fail(monkeypatch):
    """The card's host has no grpcio: the grpc line is a FAIL naming the
    module, and the device and TCP lines still report OK."""
    from fedml_tpu_torch.utils.diagnosis import run_diagnosis
    monkeypatch.setitem(sys.modules, "grpc", None)
    report = run_diagnosis(device="cpu", grpc_port=_free_port_pair(),
                           tcp_port=_free_port_pair())
    ok, detail = report["grpc"]
    assert not ok and "grpc" in detail
    assert report["device"][0] and report["tcp"][0]


class TestScheduler:
    """``api/scheduler.py`` (a copy): the allocation store's matcher, a
    launch claiming and releasing capacity, and the monitor relaunching a
    crashed run on the device it was launched with."""

    @pytest.fixture()
    def slots(self, runs_dir, monkeypatch):
        from fedml_tpu_torch.api.scheduler import _reset_default_db
        monkeypatch.setenv("FEDML_TPU_LOCAL_SLOTS", "2")
        _reset_default_db()
        yield runs_dir
        _reset_default_db()

    def test_register_match_allocate_release(self, slots):
        from fedml_tpu_torch.api.scheduler import ResourceDB
        db = ResourceDB(str(slots / "r.db"))
        db.register_device("gpu-a", 4)
        db.register_device("gpu-b", 2)
        assert db.match(3) == "gpu-a"
        assert db.allocate("run1", 3) == "gpu-a"
        assert db.allocate("run2", 2) == "gpu-b"
        assert db.allocate("run3", 2) is None
        assert db.release("run1") is True and db.release("nope") is False
        assert db.allocate("run3", 2) == "gpu-a"

    def test_launch_claims_and_releases_capacity(self, slots, tmp_path):
        from fedml_tpu_torch.api.scheduler import default_db
        big = tmp_path / "big.yaml"
        big.write_text("job: sleep 30\ncomputing:\n  device_slots: 2\n")
        small = tmp_path / "small.yaml"
        small.write_text("job: 'true'\ncomputing:\n  device_slots: 1\n")
        res = api.launch_job(str(big))
        assert res.result_code == 0 and default_db().free_slots("local") == 0
        res2 = api.launch_job(str(small))
        assert res2.result_code != 0 and "free slots" in res2.result_message
        api.run_stop(res.run_id)
        assert default_db().free_slots("local") == 2
        res3 = api.launch_job(str(small))
        assert api.run_wait(res3.run_id, timeout_s=30) == api.STATUS_FINISHED
        assert default_db().free_slots("local") == 2

    def test_monitor_restart_keeps_the_device(self, slots, tmp_path):
        import signal
        from fedml_tpu_torch.api.scheduler import JobMonitor
        job = tmp_path / "job.yaml"
        job.write_text("job: sleep 60\nrestart: true\n")
        res = api.launch_job(str(job), device="cpu")
        os.killpg(os.getpgid(res.inner_id), signal.SIGKILL)
        os.waitpid(res.inner_id, 0)
        mon = JobMonitor(interval_s=0.2, max_restarts=1)
        assert mon.scan_once() == [res.run_id]
        new_id = mon.restarted[res.run_id]
        meta = api._read_meta(new_id)
        try:
            assert meta["restart_of"] == res.run_id
            assert meta["device"] == "cpu"
            assert api.run_status(new_id) == api.STATUS_RUNNING
        finally:
            api.run_stop(new_id)
