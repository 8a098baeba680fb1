"""Device resolution (counterpart of ``fedml_tpu/device.py``).

The port runs on CUDA. The CPU is used only when the caller asks for it by
name, as the parity tests do; a host without CUDA is an error, never a quiet
fall back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def get_device(device: Optional[Union[str, torch.device]] = None
               ) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device (raises without
    one); ``"cpu"`` -> the CPU; ``"cuda:k"`` -> that card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def get_mesh(args=None, device=None):
    """``(mesh, device)`` of a run: the ``DeviceMesh`` of
    ``args.mesh_shape`` over the launch's ranks and this rank's device
    (the counterpart of ``fedml_tpu/device.py``'s ``build_mesh`` branch).
    No ``mesh_shape``, or a world of one rank with no process group, is
    ``(None, get_device(device))``: one process, today's path. A
    torchrun-style environment joins its group first
    (:func:`~fedml_tpu_torch.core.mesh.init_ranks`). A shape whose product
    is not the world size raises, naming the launch: a run never trains
    quietly on fewer ranks than its mesh."""
    import math

    from .core import mesh as mesh_mod
    shape = getattr(args, "mesh_shape", None) if args is not None else None
    if not shape:
        return None, get_device(device)
    dev = mesh_mod.init_ranks(device)
    try:
        mesh_mod.mesh_axes(shape, mesh_mod.world_size())
    except ValueError as e:
        sizes = [int(s) for s in shape.values()]
        n = "W" if -1 in sizes else math.prod(sizes)
        raise ValueError(f"{e}; {mesh_mod.LAUNCH_HINT.format(n=n)}") \
            from None
    if dev is None:                      # one process, no group: size 1
        return None, get_device(device)
    return mesh_mod.build_mesh(shape, dev), dev
