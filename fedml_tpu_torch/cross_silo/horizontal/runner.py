"""Horizontal cross-silo runner (counterpart of
``fedml_tpu/cross_silo/horizontal/runner.py``).

Builds the server or a silo per ``args.role`` / ``args.rank`` over the
chosen WAN backend (INPROC, TCP, GRPC, PUBSUB / PUBSUB_STORAGE /
MQTT_S3_LOCAL, TRPC), plus :func:`run_cross_silo_inproc`: server + N silo
clients as threads over the in-proc broker, the exact Message FSM of a
real deployment. ``round_mode: async_buffered`` builds the buffered-async
server (:mod:`..server.async_server`), as the JAX runner does. Every
party runs on ``device``: the builders take it as given, the in-proc
helper resolves it as ``run_simulation`` does (CUDA unless ``"cpu"``; no
CUDA and no ``"cpu"`` raises). The protocols the JAX runner also
dispatches (secure aggregation, split learning, gossip, vertical FL) are
not ported yet and raise NotImplementedError naming themselves.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...core.algframe.client_trainer import make_trainer_spec
from ...core.algframe.local_training import evaluate
from ...optimizers.registry import create_optimizer
from ...simulation.gpu.engine import load_params
from ..client.fedml_client_master_manager import ClientMasterManager
from ..client.trainer import SiloTrainer
from ..server.fedml_aggregator import FedMLAggregator
from ..server.fedml_server_manager import FedMLServerManager

logger = logging.getLogger(__name__)

# federated_optimizer values whose cross-silo protocols are not ported
_UNPORTED_PROTOCOLS = {
    "sa": "secure aggregation (federated_optimizer SA, cross_silo/secagg)",
    "secagg": "secure aggregation (federated_optimizer SA, "
              "cross_silo/secagg)",
    "lsa": "LightSecAgg (federated_optimizer LSA, cross_silo/lightsecagg)",
    "lightsecagg": "LightSecAgg (federated_optimizer LSA, "
                   "cross_silo/lightsecagg)",
    "split_nn": "split learning (federated_optimizer split_nn, "
                "cross_silo/split_learning.py)",
    "splitnn": "split learning (federated_optimizer split_nn, "
               "cross_silo/split_learning.py)",
    "decentralized_fl": "gossip learning (federated_optimizer "
                        "decentralized_fl, cross_silo/decentralized.py)",
    "gossip": "gossip learning (federated_optimizer decentralized_fl, "
              "cross_silo/decentralized.py)",
    "classical_vertical": "vertical FL (cross_silo/vertical.py)",
    "vertical_fl": "vertical FL (cross_silo/vertical.py)",
    "vfl": "vertical FL (cross_silo/vertical.py)",
}


def check_protocol(args) -> None:
    """Refuse the cross-silo protocols the port lacks."""
    fo = str(getattr(args, "federated_optimizer", "FedAvg")).lower()
    if fo in _UNPORTED_PROTOCOLS:
        raise NotImplementedError(
            f"{_UNPORTED_PROTOCOLS[fo]} is not ported to fedml_tpu_torch "
            f"yet (ported cross-silo: the horizontal FedAvg session, "
            f"synchronous or round_mode: async_buffered)")


def _build_spec(fed, bundle, client_trainer):
    return (client_trainer if client_trainer is not None
            else make_trainer_spec(fed, bundle))


def _make_eval_fn(spec, fed, device):
    test = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in fed.test.items()}

    def eval_fn(params):
        stats = evaluate(spec, params, test["x"], test["y"], test["mask"])
        n = max(float(stats["count"]), 1.0)
        return {"test_acc": float(stats["correct"]) / n,
                "test_loss": float(stats["loss_sum"]) / n}

    eval_fn.batches = int(test["x"].shape[0])   # forward passes per eval
    return eval_fn


def build_server(args, fed, bundle, spec=None, backend: Optional[str] = None,
                 comm=None, *, device,
                 init_params: Optional[Dict[str, Any]] = None):
    """The server FSM on ``device``, starting from ``init_params`` (a state
    dict; :mod:`fedml_tpu_torch.interop` brings a flax tree) or the
    bundle's seeded init."""
    check_protocol(args)
    device = torch.device(device)
    spec = _build_spec(fed, bundle, spec)
    seed = int(getattr(args, "random_seed", 0))
    if init_params is None:
        global_params = bundle.init(torch.Generator().manual_seed(seed),
                                    device)
    else:
        global_params = load_params(bundle, init_params, device)
    size = int(getattr(args, "client_num_per_round", 1)) + 1
    from ...core.async_rounds import round_mode_from_args
    if round_mode_from_args(args) == "async_buffered":
        # buffered-async session: pours replace rounds (no barrier FSM)
        from ..server.async_server import (AsyncFedMLAggregator,
                                           AsyncFedMLServerManager)
        aggregator = AsyncFedMLAggregator(
            args, global_params, eval_fn=_make_eval_fn(spec, fed, device),
            device=device)
        return AsyncFedMLServerManager(
            args, aggregator, comm=comm, rank=0, size=size,
            backend=backend or _wan_backend(args))
    aggregator = FedMLAggregator(args, global_params,
                                 eval_fn=_make_eval_fn(spec, fed, device))
    return FedMLServerManager(
        args, aggregator, comm=comm, rank=0, size=size,
        backend=backend or _wan_backend(args))


def build_client(args, fed, bundle, rank: int, spec=None,
                 backend: Optional[str] = None, comm=None, *, device):
    """Silo ``rank``'s FSM, training on ``device``."""
    check_protocol(args)
    spec = _build_spec(fed, bundle, spec)
    optimizer = create_optimizer(args, spec)
    trainer = SiloTrainer(args, fed, bundle, spec, optimizer, device)
    size = int(getattr(args, "client_num_per_round", 1)) + 1
    return ClientMasterManager(
        args, trainer, comm=comm, rank=rank, size=size,
        backend=backend or _wan_backend(args))


# the transports ``args.backend`` may name; any other value (a simulation
# backend's name, or none) means GRPC, as in the JAX package. Its runner
# maps PUBSUB and TRPC to GRPC too; here they reach their transports, so
# a party built from ``args`` alone (``silo_main``) can use them
WAN_BACKENDS = ("INPROC", "TCP", "GRPC", "PUBSUB", "PUBSUB_STORAGE",
                "MQTT_S3_LOCAL", "TRPC")


def _wan_backend(args) -> str:
    b = str(getattr(args, "backend", "") or "").upper()
    return b if b in WAN_BACKENDS else "GRPC"


class CrossSiloRunner:
    """Single-role entry: ``args.role`` decides server vs client;
    ``run()`` blocks until the FL session finishes. A user
    ``ServerAggregator`` is not taken here (neither does the JAX
    package's horizontal runner)."""

    def __init__(self, args, dataset, model, client_trainer=None,
                 server_aggregator=None, *, device,
                 init_params: Optional[Dict[str, Any]] = None):
        self.args = args
        self.fed = dataset
        self.bundle = model
        role = str(getattr(args, "role", "client")).lower()
        rank = int(getattr(args, "rank", 1) or 1)
        if role == "server":
            self.manager = build_server(args, dataset, model, client_trainer,
                                        device=device,
                                        init_params=init_params)
        else:
            self.manager = build_client(args, dataset, model, max(rank, 1),
                                        client_trainer, device=device)

    def run(self, comm_round=None) -> Any:
        self.manager.run()
        return getattr(self.manager, "result", None)


def run_cross_silo_inproc(args, fed, bundle, spec=None, device=None,
                          init_params: Optional[Dict[str, Any]] = None,
                          join_timeout_s: float = 30.0) -> Dict[str, Any]:
    """Server + N silo clients as threads over the in-proc broker, every
    party on ``device`` (CUDA unless ``"cpu"``; without CUDA and without
    ``device="cpu"`` it raises before any work). Each party gets its own
    copy of ``bundle``: a forward swaps the module's parameters in
    (``functional_call``), so threads must not share one module (a
    caller's ``spec`` is shared as given)."""
    import copy

    from ...device import get_device
    from .. import run_inproc_session
    device = get_device(device)
    n = int(getattr(args, "client_num_per_round", 2))
    return run_inproc_session(args, lambda: [
        build_server(args, fed, bundle, spec, backend="INPROC",
                     device=device, init_params=init_params),
        *[build_client(args, fed, copy.deepcopy(bundle), rank=r, spec=spec,
                       backend="INPROC", device=device)
          for r in range(1, n + 1)]],
        join_timeout_s=join_timeout_s)
