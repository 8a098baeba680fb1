"""Hierarchical cross-silo session builders (counterpart of
``fedml_tpu/cross_silo/hierarchical/runner.py``).

The server is the horizontal one. A silo's rank 0 is a
:class:`~..client.fedml_client_master_manager.ClientMasterManager` over a
:class:`.trainer.HierarchicalSiloTrainer`; the silo's other ranks follow
its trainings over the silo's process group (:mod:`.process_group`). The
in-proc session runs each silo as one rank (world size 1) on ``device``.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Optional

import torch

from ...core.algframe.client_trainer import make_trainer_spec
from ...optimizers.registry import create_optimizer
from ..client.fedml_client_master_manager import ClientMasterManager
from ..horizontal.runner import _wan_backend, build_server
from .trainer import HierarchicalSiloTrainer


def build_hierarchical_client(args, fed, bundle, rank: int,
                              backend: str = "INPROC", spec=None, comm=None,
                              *, device):
    """Silo ``rank``'s FSM over a hierarchical trainer on ``device``."""
    spec = spec if spec is not None else make_trainer_spec(fed, bundle)
    trainer = HierarchicalSiloTrainer(args, fed, bundle, spec,
                                      create_optimizer(args, spec),
                                      torch.device(device))
    size = int(getattr(args, "client_num_per_round", 1)) + 1
    return ClientMasterManager(args, trainer, comm=comm, rank=rank,
                               size=size, backend=backend)


def run_hierarchical_cross_silo_inproc(
        args, fed, bundle, device=None,
        init_params: Optional[Dict[str, Any]] = None,
        join_timeout_s: float = 30.0) -> Dict[str, Any]:
    """Server + N hierarchical silos as threads over the in-proc broker,
    every party on ``device`` (CUDA unless ``"cpu"``); each silo is one
    rank, so it trains as the horizontal silo does."""
    from ...device import get_device
    from .. import run_inproc_session
    device = get_device(device)
    n = int(getattr(args, "client_num_per_round", 2))
    return run_inproc_session(args, lambda: [
        build_server(args, fed, bundle, backend="INPROC", device=device,
                     init_params=init_params),
        *[build_hierarchical_client(args, fed, copy.deepcopy(bundle),
                                    rank=r, backend="INPROC", device=device)
          for r in range(1, n + 1)]],
        join_timeout_s=join_timeout_s)


def _silo_device(device) -> torch.device:
    """A multi-rank silo on several cards: each rank takes its own
    (``LOCAL_RANK``, else ``RANK`` modulo the cards)."""
    import torch.distributed as dist
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or not (
            dist.is_available() and dist.is_initialized()):
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    index = local % max(torch.cuda.device_count(), 1)
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


class HierarchicalCrossSiloRunner:
    """Single-role entry: the server is the horizontal server; a silo
    joins its process group (a no-op at world size 1), and its rank 0
    runs the WAN FSM while the other ranks follow."""

    def __init__(self, args, dataset, model, client_trainer=None,
                 server_aggregator=None, *, device,
                 init_params: Optional[Dict[str, Any]] = None):
        from .process_group import init_silo_process_group
        self.follower = None
        role = str(getattr(args, "role", "client")).lower()
        if role == "server":
            self.manager = build_server(args, dataset, model, client_trainer,
                                        device=device,
                                        init_params=init_params)
            return
        device = torch.device(device)
        init_silo_process_group(device=device)
        device = _silo_device(device)
        spec = (client_trainer if client_trainer is not None
                else make_trainer_spec(dataset, model))
        if _silo_rank() != 0:
            self.follower = HierarchicalSiloTrainer(
                args, dataset, model, spec, create_optimizer(args, spec),
                device)
            return
        rank = max(int(getattr(args, "rank", 1) or 1), 1)
        self.manager = build_hierarchical_client(
            args, dataset, model, rank=rank, backend=_wan_backend(args),
            spec=spec, device=device)

    def run(self, comm_round=None):
        from .process_group import close_silo_process_group
        if self.follower is not None:
            self.follower.follow()
            close_silo_process_group()
            return None
        try:
            self.manager.run()
        finally:
            trainer = getattr(self.manager, "trainer", None)
            if isinstance(trainer, HierarchicalSiloTrainer):
                trainer.release()
                close_silo_process_group()
        return getattr(self.manager, "result", None)


def _silo_rank() -> int:
    import torch.distributed as dist
    return (dist.get_rank() if dist.is_available() and dist.is_initialized()
            else 0)
