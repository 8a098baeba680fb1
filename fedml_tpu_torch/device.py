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
