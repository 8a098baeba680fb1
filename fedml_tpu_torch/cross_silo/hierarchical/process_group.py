"""A silo's process group (counterpart of
``fedml_tpu/cross_silo/hierarchical/process_group.py``; reference
``process_group_manager.py:8``).

Every rank of a multi-rank silo runs the same program and joins one
``torch.distributed`` process group: NCCL on the card, gloo on the CPU.
The silo's rank 0 then speaks the WAN FSM and the others follow its
local trainings (:mod:`.trainer`).

Env contract (torchrun's names, as in the JAX package, so the reference's
launch scripts port): ``MASTER_ADDR`` / ``MASTER_PORT`` -> the rendezvous
(``tcp://addr:port``), ``WORLD_SIZE`` -> the silo's ranks, ``RANK`` ->
this rank.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)


def silo_env(coordinator: Optional[str] = None,
             num_hosts: Optional[int] = None,
             host_rank: Optional[int] = None):
    """``(coordinator "addr:port", world size, rank)`` from the arguments,
    else the env contract."""
    num_hosts = int(num_hosts if num_hosts is not None
                    else os.environ.get("WORLD_SIZE", "1"))
    host_rank = int(host_rank if host_rank is not None
                    else os.environ.get("RANK", "0"))
    coordinator = coordinator or (
        os.environ.get("MASTER_ADDR", "127.0.0.1") + ":" +
        os.environ.get("MASTER_PORT", "29500"))
    return coordinator, num_hosts, host_rank


def init_silo_process_group(coordinator: Optional[str] = None,
                            num_hosts: Optional[int] = None,
                            host_rank: Optional[int] = None,
                            device="cuda") -> bool:
    """Join this rank to the silo's process group: NCCL when the silo runs
    on ``device`` ``"cuda"`` (the default), gloo on ``"cpu"``. A no-op
    (False) at world size 1; True when the group is up (also when it
    already was)."""
    import torch
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return True
    coordinator, num_hosts, host_rank = silo_env(coordinator, num_hosts,
                                                 host_rank)
    if num_hosts <= 1:
        return False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator}",
                            world_size=num_hosts, rank=host_rank)
    logger.info("silo process group up: rank %d/%d via %s (%s)", host_rank,
                num_hosts, coordinator, backend)
    return True


def close_silo_process_group() -> None:
    """Leave the silo's process group (after a barrier, so no rank leaves
    while another still reads its last broadcast); a no-op when none is
    up. A process that exits with the group up can abort in the
    backend's threads."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
