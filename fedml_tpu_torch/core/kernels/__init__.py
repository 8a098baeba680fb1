"""Hand-written CUDA kernels and their plain PyTorch versions.

Each kernel's wrapper carries three counters: ``launches``, the kernel
launches it made (one per launch, eagerly or by a replayed CUDA graph);
``captured``, the launches it recorded into a CUDA graph being captured
(recorded, not run); and ``analysed``, the launches a roofline capture
made (``core/obs/roofline.py``: one run of a program on copies of its
inputs, which the program's own count leaves out). A graph's replay adds
the launches it holds to ``launches``
(``core/algframe/local_training.py::StepProgram``).
"""

from __future__ import annotations

import torch


def count_launch(wrapper, work=None) -> None:
    """Count one launch of ``wrapper``'s kernel on the current stream.
    ``work()`` gives the launch's roofline row (operand shapes, output
    shape, bytes, FLOPs; :mod:`.cost`), read only while a roofline capture
    runs: the launch is then reported to it and counted in
    ``analysed``."""
    from ..obs import roofline
    if roofline.kernel_launch(wrapper, work):
        wrapper.analysed += 1
    elif torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


def counted_kernels():
    """The wrappers whose launches are counted."""
    from . import conv_block, flash_attention
    return (conv_block.fused_block, flash_attention.flash_fwd,
            flash_attention.flash_dq, flash_attention.flash_dkv)


def launch_counts():
    """Each counted wrapper's ``launches``, by its name."""
    return {fn.__name__: int(fn.launches) for fn in counted_kernels()}
