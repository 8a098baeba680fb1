"""The port stands alone: importing every module of ``fedml_tpu_torch``
loads neither JAX, flax nor anything of ``fedml_tpu``; and its entry point
refuses to run on a host without CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

import fedml_tpu_torch

pytestmark = pytest.mark.torch_port

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import fedml_tpu_torch
names = ["fedml_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(fedml_tpu_torch.__path__,
                                          "fedml_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "fedml_tpu"))
print(len(names), bad)
"""


def test_no_jax_or_fedml_tpu_imported():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = _ROOT
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 25  # every module of the package was imported
    assert bad == "[]", bad


_SERVING_PROBE = r"""
import sys
import fedml_tpu_torch.llm.kv_cache
import fedml_tpu_torch.serving
import fedml_tpu_torch.serving.batch
import fedml_tpu_torch.serving.llm_template
import fedml_tpu_torch.core.obs
from fedml_tpu_torch.serving.llm_template import CausalLMPredictor
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "fedml_tpu"))
print(bad)
"""


def test_serving_and_kv_cache_import_without_jax():
    """The serving slice (``serving``, ``serving.batch``, the template,
    ``llm.kv_cache`` and the obs copies) imports on its own with no JAX
    module loaded: the obs copies do not reach the JAX package's
    ``mlops``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = _ROOT
    out = subprocess.run([sys.executable, "-c", _SERVING_PROBE], cwd=_ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_point_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fedml_tpu_torch.run_simulation()
    with pytest.raises(RuntimeError, match="CUDA"):
        fedml_tpu_torch.run_simulation(device="cuda")
    from fedml_tpu_torch.device import get_device
    assert get_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        get_device("mps")


_FLEET_PROBE = r"""
import runpy, sys
import fedml_tpu_torch.core.chaos.serving
import fedml_tpu_torch.core.distributed.communication.backoff
import fedml_tpu_torch.serving.autoscale
import fedml_tpu_torch.serving.replica_main
from fedml_tpu_torch.core.chaos import ServingChaosInjector
from fedml_tpu_torch.core.obs.flight import install_signal_dump
from fedml_tpu_torch.core.obs.metrics import (
    record_fleet_scale, record_gateway_failover, record_gateway_heal,
    record_gateway_latency, record_gateway_route)
load = runpy.run_path("scripts/serving_load_torch.py")
assert callable(load["run_load"]) and callable(load["build_sessions"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "fedml_tpu"))
print(bad)
"""


def test_fleet_chaos_and_load_script_import_without_jax():
    """The serving fleet (``serving/autoscale.py``, ``replica_main``), the
    serving chaos injector, the retry policy copy, the fleet's metric
    records and ``scripts/serving_load_torch.py`` load no JAX module and
    nothing of ``fedml_tpu``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = _ROOT
    out = subprocess.run([sys.executable, "-c", _FLEET_PROBE], cwd=_ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("path", ["chip_smoke.py",
                                  "scripts/serving_load_torch.py",
                                  "scripts/fleet_scaling.py",
                                  "scripts/serving_ab.py",
                                  "scripts/chip_phases.py",
                                  "fedml_tpu_torch/serving/autoscale.py",
                                  "fedml_tpu_torch/serving/replica_main.py"])
def test_no_jax_import_statement(path):
    """No import statement of these files names JAX or the JAX package
    (``chip_smoke.py`` and the scripts that drive it run only on a card,
    so their text is read)."""
    import ast
    with open(os.path.join(_ROOT, path)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "jaxlib", "flax", "fedml_tpu")]
    assert not bad, bad


_NO_GRPC_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys


class _NoGrpc(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "grpc" or name.startswith("grpc."):
            raise ModuleNotFoundError(f"No module named {name!r}")
        return None


sys.meta_path.insert(0, _NoGrpc())
import fedml_tpu_torch
names = ["fedml_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(fedml_tpu_torch.__path__,
                                          "fedml_tpu_torch.")]
for n in names:
    importlib.import_module(n)
from fedml_tpu_torch.core.distributed.communication.grpc import \
    GRPCCommManager
try:
    GRPCCommManager(0, base_port=1)
except ModuleNotFoundError as e:
    refused = "grpc" in str(e)
else:
    refused = False
print(len(names), refused, "grpc" in sys.modules,
      "fedml_tpu_torch.cross_silo.horizontal.runner" in names)
"""


def test_package_imports_without_grpc():
    """The card's host lists no ``grpcio``: every module of the port
    (the cross-silo runtime and its gRPC transport among them) imports
    with ``grpc`` hidden; only building a GRPC transport needs it."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = _ROOT
    out = subprocess.run([sys.executable, "-c", _NO_GRPC_PROBE], cwd=_ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    count, refused, loaded, walked = out.stdout.split()
    assert int(count) >= 25
    assert (refused, loaded, walked) == ("True", "False", "True")
