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
CUDA and no ``"cpu"`` raises). ``federated_optimizer`` SA / secagg and
LSA / lightsecagg build the secure-aggregation managers (``cross_silo/
secagg``, ``cross_silo/lightsecagg``; their silos train plain FedAvg
steps), before the ``round_mode`` dispatch, as the JAX runner does; their
modules need the ``cryptography`` package and are imported only here, so
a host without it fails at build, naming it, and runs every other
session. split_nn / splitnn, decentralized_fl / gossip and
classical_vertical / vertical_fl / vfl build the split-learning, gossip
and vertical-FL managers.
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

SA_FOS = ("sa", "secagg")
LSA_FOS = ("lsa", "lightsecagg")
SPLIT_FOS = ("split_nn", "splitnn")
GOSSIP_FOS = ("decentralized_fl", "gossip")
VERTICAL_FOS = ("classical_vertical", "vertical_fl", "vfl")


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


def _global_init(args, bundle, device, init_params):
    """The server's starting model on ``device``: ``init_params`` (a state
    dict) or the bundle's init seeded by ``random_seed``."""
    if init_params is None:
        seed = int(getattr(args, "random_seed", 0))
        return bundle.init(torch.Generator().manual_seed(seed), device)
    return load_params(bundle, init_params, device)


def build_server(args, fed, bundle, spec=None, backend: Optional[str] = None,
                 comm=None, *, device,
                 init_params: Optional[Dict[str, Any]] = None):
    """The server FSM on ``device``, starting from ``init_params`` (a state
    dict; :mod:`fedml_tpu_torch.interop` brings a flax tree) or the
    bundle's seeded init."""
    device = torch.device(device)
    spec = _build_spec(fed, bundle, spec)
    global_params = _global_init(args, bundle, device, init_params)
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
    spec = _build_spec(fed, bundle, spec)
    optimizer = create_optimizer(args, spec)
    trainer = SiloTrainer(args, fed, bundle, spec, optimizer, device)
    size = int(getattr(args, "client_num_per_round", 1)) + 1
    return ClientMasterManager(
        args, trainer, comm=comm, rank=rank, size=size,
        backend=backend or _wan_backend(args))


def build_secure_server(args, fed, bundle, fo: str, spec=None,
                        backend: Optional[str] = None, *, device,
                        init_params: Optional[Dict[str, Any]] = None):
    """The SA (``fo`` in :data:`SA_FOS`) or LSA server on ``device``."""
    device = torch.device(device)
    spec = _build_spec(fed, bundle, spec)
    kw = dict(eval_fn=_make_eval_fn(spec, fed, device), rank=0,
              size=int(getattr(args, "client_num_per_round", 1)) + 1,
              backend=backend or _wan_backend(args))
    params = _global_init(args, bundle, device, init_params)
    if fo in SA_FOS:
        from ..secagg import SecAggServerManager
        return SecAggServerManager(args, params, **kw)
    from ..lightsecagg import LSAServerManager
    return LSAServerManager(args, params, **kw)


def build_secure_client(args, fed, bundle, fo: str, rank: int, spec=None,
                        backend: Optional[str] = None, *, device,
                        client_factory=None):
    """SA or LSA silo ``rank``, training plain FedAvg steps on ``device``;
    ``client_factory(rank, args, trainer)`` builds the manager instead
    (tests inject faulty silos)."""
    import copy
    spec = _build_spec(fed, bundle, spec)
    inner_args = copy.copy(args)
    inner_args.federated_optimizer = "FedAvg"  # the local step is FedAvg
    trainer = SiloTrainer(args, fed, bundle, spec,
                          create_optimizer(inner_args, spec), device)
    if client_factory is not None:
        return client_factory(rank, args, trainer)
    kw = dict(rank=rank,
              size=int(getattr(args, "client_num_per_round", 1)) + 1,
              backend=backend or _wan_backend(args))
    if fo in SA_FOS:
        from ..secagg import SecAggClientManager
        return SecAggClientManager(args, trainer, **kw)
    from ..lightsecagg import LSAClientManager
    return LSAClientManager(args, trainer, **kw)


def run_secure_inproc(args, fed, bundle, fo: str, spec=None,
                      client_factory=None, device=None,
                      init_params: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
    """An SA or LSA session over the in-proc broker: the server on the
    calling thread, each silo on a thread of its own with its own copy of
    ``bundle``, every party on ``device`` (CUDA unless ``"cpu"``)."""
    import copy

    from ...device import get_device
    from .. import run_inproc_session
    device = get_device(device)
    n = int(getattr(args, "client_num_per_round", 2))
    return run_inproc_session(args, lambda: [
        build_secure_server(args, fed, bundle, fo, spec, backend="INPROC",
                            device=device, init_params=init_params),
        *[build_secure_client(args, fed, copy.deepcopy(bundle), fo, r, spec,
                              backend="INPROC", device=device,
                              client_factory=client_factory)
          for r in range(1, n + 1)]], join_timeout_s=30.0)


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
    """Single-role entry: ``args.role`` decides server vs client, and
    ``federated_optimizer`` the protocol (SA, LSA, split learning,
    gossip, vertical FL, else FedAvg); ``run()`` blocks until the FL
    session finishes. A gossip node's rank is 0 for the server role, else
    ``max(rank, 1)``; split learning's ``init_params`` is ``{"bottom",
    "top"}``, vertical FL's one state dict per party. A user ``ServerAggregator`` is not
    taken here (neither does the JAX package's horizontal runner)."""

    def __init__(self, args, dataset, model, client_trainer=None,
                 server_aggregator=None, *, device,
                 init_params: Optional[Dict[str, Any]] = None):
        self.args = args
        self.fed = dataset
        self.bundle = model
        role = str(getattr(args, "role", "client")).lower()
        rank = int(getattr(args, "rank", 1) or 1)
        fo = str(getattr(args, "federated_optimizer", "FedAvg")).lower()
        backend = _wan_backend(args)
        if fo in SA_FOS + LSA_FOS:
            # before the round_mode dispatch of build_server, as in JAX
            if role == "server":
                self.manager = build_secure_server(
                    args, dataset, model, fo, client_trainer, device=device,
                    init_params=init_params)
            else:
                self.manager = build_secure_client(
                    args, dataset, model, fo, max(rank, 1), client_trainer,
                    device=device)
        elif fo in SPLIT_FOS:
            # activations and their gradients cross the transport
            from ..split_learning import (SplitNNClientManager,
                                          SplitNNServerManager)
            n = int(getattr(args, "client_num_per_round", 1))
            init = init_params or {}
            if role == "server":
                self.manager = SplitNNServerManager(
                    args, dataset.num_classes, size=n + 1, backend=backend,
                    device=device, init_params=init.get("top"))
            else:
                self.manager = SplitNNClientManager(
                    args, dataset, rank=max(rank, 1), size=n + 1,
                    backend=backend, device=device,
                    init_params=init.get("bottom"))
        elif fo in GOSSIP_FOS:
            # serverless: every process is a gossip node; rank == node
            from ..decentralized import GossipNodeManager
            n = int(getattr(args, "client_num_in_total", 2))
            self.manager = GossipNodeManager(
                args, dataset, model,
                rank=0 if role == "server" else max(rank, 1), size=n,
                backend=backend, device=device, init_params=init_params,
                spec=client_trainer)
        elif fo in VERTICAL_FOS:
            from ..vertical import VFLPartyManager, VFLServerManager
            n = int(getattr(args, "party_num", 2) or 2)
            if role == "server":
                self.manager = VFLServerManager(
                    args, dataset, size=n + 1, backend=backend,
                    device=device)
            else:
                self.manager = VFLPartyManager(
                    args, dataset, rank=max(rank, 1), size=n + 1,
                    backend=backend, device=device, init_params=init_params)
        elif role == "server":
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
