"""Cross-device runner (counterpart of ``fedml_tpu/cross_device/runner.py``):
builds the ServerMNN-analogue side or a simulated device per
``args.role``, plus the in-proc session helper used by tests (reference
``launch_cross_device.py`` ``run_mnn_server``). Every party runs on
``device``: the build functions take it as given, the in-proc helper
and the runner resolve it as ``run_simulation`` does (CUDA unless
``"cpu"``; no CUDA and no ``"cpu"`` raises)."""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

from ..core.algframe.client_trainer import make_trainer_spec
from ..cross_silo.horizontal.runner import _global_init, _make_eval_fn
from ..device import get_device
from ..optimizers.registry import create_optimizer
from .client import DeviceClientManager
from .server import DeviceAggregator, DeviceServerManager


def build_device_server(args, fed, bundle, backend: Optional[str] = None, *,
                        device,
                        init_params: Optional[Dict[str, Any]] = None):
    """The device server on ``device``, starting from ``init_params`` (a
    state dict) or the bundle's init seeded by ``random_seed``."""
    spec = make_trainer_spec(fed, bundle)
    global_params = _global_init(args, bundle, device, init_params)
    aggregator = DeviceAggregator(args, global_params,
                                  eval_fn=_make_eval_fn(spec, fed, device))
    size = int(getattr(args, "client_num_per_round", 1)) + 1
    return DeviceServerManager(args, aggregator, rank=0, size=size,
                               backend=backend or _backend(args))


def build_device_client(args, fed, bundle, device_id: int,
                        backend: Optional[str] = None,
                        engine: Optional[str] = None,
                        eligibility: Optional[dict] = None, *, device):
    spec = make_trainer_spec(fed, bundle)
    optimizer = create_optimizer(args, spec)
    return DeviceClientManager(args, fed, bundle, spec, optimizer,
                               device_id, backend=backend or _backend(args),
                               engine=engine, eligibility=eligibility,
                               device=device)


def _backend(args) -> str:
    b = str(getattr(args, "backend", "") or "").upper()
    return b if b in ("INPROC", "TCP", "GRPC") else "TCP"


class CrossDeviceRunner:
    """``args.role`` == 'server' runs the MNN-server analogue; anything else
    runs one simulated device (``args.rank`` = device id)."""

    def __init__(self, args, dataset, model, device=None,
                 init_params: Optional[Dict[str, Any]] = None):
        device = get_device(device)
        role = str(getattr(args, "role", "server")).lower()
        if role == "server":
            self.manager = build_device_server(args, dataset, model,
                                               device=device,
                                               init_params=init_params)
        else:
            self.manager = build_device_client(
                args, dataset, model, max(int(getattr(args, "rank", 1)), 1),
                device=device)

    def run(self, comm_round=None) -> Any:
        self.manager.run()
        return getattr(self.manager, "result", None)


def build_cross_device_runner(args, dataset, model, device=None,
                              init_params: Optional[Dict[str, Any]] = None):
    return CrossDeviceRunner(args, dataset, model, device=device,
                             init_params=init_params)


def run_cross_device_inproc(args, fed, bundle,
                            engines: Optional[list] = None,
                            eligibility: Optional[list] = None,
                            device=None,
                            init_params: Optional[Dict[str, Any]] = None,
                            join_timeout_s: float = 30.0
                            ) -> Dict[str, Any]:
    """Server + N simulated devices as threads over the in-proc broker —
    the cross-device 'multi-node without a cluster' test mode, every party
    on ``device``. ``eligibility`` (optional, per device):
    charging/idle/unmetered handshake overrides the cohort-assembly
    predicates read. Each device gets its own copy of ``bundle`` (a
    forward swaps the module's parameters in)."""
    from ..cross_silo import run_inproc_session
    device = get_device(device)
    n = int(getattr(args, "client_num_per_round", 2))
    engs = engines or [None] * n
    eligs = eligibility or [None] * n
    return run_inproc_session(args, lambda: [
        build_device_server(args, fed, bundle, backend="INPROC",
                            device=device, init_params=init_params),
        *[build_device_client(args, fed, copy.deepcopy(bundle),
                              device_id=i + 1, backend="INPROC",
                              engine=engs[i], eligibility=eligs[i],
                              device=device)
          for i in range(n)]], join_timeout_s=join_timeout_s)
