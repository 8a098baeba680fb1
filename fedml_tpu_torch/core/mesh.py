"""The rank mesh (counterpart of ``fedml_tpu/core/mesh.py``).

The JAX package runs one process over a named ``jax.sharding.Mesh`` of
devices. The port runs one process per rank, PyTorch's idiom: ``torchrun
--nproc_per_node W`` (or :func:`fedml_tpu_torch.core.launch.run_ranks`)
starts W processes, each joins one ``torch.distributed`` group
(:func:`init_ranks`), and :func:`build_mesh` lays the ranks out as a
``DeviceMesh`` with the JAX package's axis names. ``mesh_shape`` keeps its
meaning: an ordered map of axis names to sizes, at most one ``-1`` (the
rest of the ranks), whose product is the world size where JAX's is the
device count.

Device and backend: rank ``r`` runs on ``cuda:(LOCAL_RANK % device_count)``,
or on the CPU when the caller asks for it. NCCL when every rank of the host
has a card of its own; gloo when ranks share a card (NCCL refuses two ranks
on one device) and on the CPU. The backend is chosen from those facts and
logged; a backend that fails to start is never retried with another.

The placements (:func:`replicated`, :func:`client_sharded`,
:func:`data_sharded`, :func:`fsdp_param_sharding`) are DTensor placements,
one per mesh dimension, in the mesh's axis order.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..constants import AXIS_CLIENT, AXIS_DATA, AXIS_FSDP, AXIS_TENSOR

logger = logging.getLogger(__name__)

LAUNCH_HINT = ("run one process per rank: torchrun --nproc_per_node {n} "
               "<script> (or fedml_tpu_torch.core.launch.run_ranks)")


def mesh_axes(mesh_shape: Optional[Dict[str, int]], n: int
              ) -> Tuple[List[str], List[int]]:
    """The axis names and sizes of ``mesh_shape`` over ``n`` ranks, by
    ``build_mesh``'s rules: ``None`` is one ``client`` axis over all of
    them; a size of ``-1`` is the rest of the ranks."""
    if not mesh_shape:
        mesh_shape = {AXIS_CLIENT: n}
    if not isinstance(mesh_shape, dict):
        raise TypeError(f"mesh_shape must map axis names to sizes, e.g. "
                        f"{{'client': 2}}; got {mesh_shape!r}")
    names = list(mesh_shape.keys())
    sizes = [int(s) for s in mesh_shape.values()]
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    fixed = math.prod(s for s in sizes if s != -1)
    sizes = [n // fixed if s == -1 else s for s in sizes]
    if math.prod(sizes) != n:
        raise ValueError(f"mesh shape {dict(zip(names, sizes))} != {n} devices")
    return names, sizes


# -- ranks -----------------------------------------------------------------

def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU when ``device`` names it, else
    ``cuda:(LOCAL_RANK % device_count)`` (raises without CUDA)."""
    from ..device import get_device
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    get_device(device)                      # no CUDA: raise, never fall back
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def choose_backend(device: torch.device, local_world: int) -> str:
    """gloo on the CPU and when the host's ranks share its cards; NCCL when
    every rank has a card of its own."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def init_ranks(device=None) -> Optional[torch.device]:
    """Join this process to its launch's process group, from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); returns this
    rank's device. With no such environment (a plain process) nothing is
    joined and None comes back. A group that is already up is kept."""
    import torch.distributed as dist
    if dist.is_initialized():
        return rank_device(device)
    if "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", "0"))
    dev = rank_device(device)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = choose_backend(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT", "29500")
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            world_size=world, rank=rank)
    logger.info("rank %d/%d on %s over %s (%d ranks on this host, %d "
                "cards)", rank, world, dev, backend, local_world,
                torch.cuda.device_count() if dev.type == "cuda" else 0)
    return dev


def close_ranks() -> None:
    """Leave the process group after a barrier (no rank leaves while
    another still waits on it); a no-op when none is up."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


# -- the mesh --------------------------------------------------------------

def build_mesh(mesh_shape: Optional[Dict[str, int]] = None,
               devices: Union[None, str, torch.device] = None):
    """A ``DeviceMesh`` over the ranks of the process group, with
    ``mesh_shape``'s axis names and sizes (ranks laid out row-major, as the
    JAX package lays out its devices). ``devices`` is the ranks' device
    type (this rank's device by default). Needs the group up
    (:func:`init_ranks`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = world_size()
    names, sizes = mesh_axes(mesh_shape, n)
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs the ranks' process group; "
                           + LAUNCH_HINT.format(n=math.prod(sizes)))
    dtype = (torch.device(devices).type if devices is not None
             else rank_device().type)
    return DeviceMesh(dtype, torch.arange(n).reshape(sizes),
                      mesh_dim_names=tuple(names))


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` (JAX's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def client_axis_size(mesh) -> int:
    return mesh_sizes(mesh).get(AXIS_CLIENT, 1)


def placements(mesh, spec: Sequence[Optional[str]]):
    """DTensor placements of a PartitionSpec-like ``spec`` (one mesh axis
    name or None per tensor dimension): ``Shard(i)`` on the mesh dimension
    that dimension ``i`` is split over, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, ax in enumerate(spec) if ax == name]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def replicated(mesh):
    """Globally replicated state."""
    return placements(mesh, ())


def client_sharded(mesh, ndim: int = 1):
    """The leading axis split over ``client`` (per-client stacked data)."""
    return placements(mesh, (AXIS_CLIENT,) + (None,) * (ndim - 1))


def data_sharded(mesh, ndim: int = 2):
    """The batch axis split over ``data`` when the mesh has it."""
    axis = AXIS_DATA if AXIS_DATA in mesh.mesh_dim_names else None
    return placements(mesh, (axis,) + (None,) * (ndim - 1))


def fsdp_dim(sizes: Dict[str, int], shape: Tuple[int, ...]) -> Optional[int]:
    """The dimension ZeRO-3 sharding splits over ``fsdp``: the largest one
    the axis divides (the first of equals), or None."""
    if AXIS_FSDP not in sizes:
        return None
    size = sizes[AXIS_FSDP]
    for i, dim in sorted(enumerate(shape), key=lambda t: -t[1]):
        if dim % size == 0:
            return i
    return None


def fsdp_param_sharding(mesh, shape: Tuple[int, ...]):
    """ZeRO-3-style parameter sharding: the largest divisible axis over
    ``fsdp``."""
    spec = [None] * len(shape)
    best = fsdp_dim(mesh_sizes(mesh), tuple(shape))
    if best is not None:
        spec[best] = AXIS_FSDP
    return placements(mesh, spec)


def logical_sharding_rules() -> List[Tuple[str, Optional[str]]]:
    """Logical-axis -> mesh-axis rules for the LLM path (TP + FSDP)."""
    return [
        ("batch", AXIS_DATA),
        ("embed", AXIS_FSDP),
        ("mlp", AXIS_TENSOR),
        ("heads", AXIS_TENSOR),
        ("kv", None),
        ("vocab", AXIS_TENSOR),
    ]
