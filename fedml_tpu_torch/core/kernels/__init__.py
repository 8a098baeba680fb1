"""Hand-written CUDA kernels and their plain PyTorch versions.

Each kernel's wrapper carries two counters: ``launches``, the kernel
launches it made (one per launch, eagerly or by a replayed CUDA graph),
and ``captured``, the launches it recorded into a CUDA graph being
captured (recorded, not run). A graph's replay adds the launches it holds
to ``launches`` (``core/algframe/local_training.py::StepProgram``).
"""

from __future__ import annotations

import torch


def count_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel on the current stream."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


def counted_kernels():
    """The wrappers whose launches are counted."""
    from . import conv_block, flash_attention
    return (conv_block.fused_block, flash_attention.flash_fwd,
            flash_attention.flash_dq, flash_attention.flash_dkv)
