"""MobileNetV3-Small, GroupNorm variant (counterpart of
``fedml_tpu/model/cv/mobilenet.py``; the FEMNIST hierarchical
benchmark's model).

The depthwise 3x3 / 5x5 convs are flax ``feature_group_count=C`` convs:
HWIO kernels ``[k, k, 1, C]``, run as ``conv2d(groups=C)`` with XLA's
``SAME`` pads (on an even input a stride-2 5x5 pads (1, 2)). Names follow
flax's auto-naming: ``InvertedResidual_k.{Conv_j, GroupNorm_j,
SqueezeExcite_0.Dense_j}``; ``Conv_0`` of a block is its expansion only
when it has one. ``hard_swish`` is ``x * relu6(x + 3) / 6`` in that order
(not ``F.hardswish``: bf16 rounds differently).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .cnn import FlaxInit, _as_image, _image_shape
from .resnet import ConvKernel, GroupNorm


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * F.relu6(x + 3.0) / 6.0


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


class SqueezeExcite(nn.Module):
    """Global mean -> Dense ``max(c / reduce, 8)`` -> relu -> Dense ``c``
    -> hard sigmoid, scaling the channels."""

    def __init__(self, c: int, reduce: int = 4):
        super().__init__()
        self.Dense_0 = nn.Linear(c, max(c // reduce, 8))
        self.Dense_1 = nn.Linear(max(c // reduce, 8), c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.Dense_0(x.mean(dim=(1, 2))))
        s = hard_sigmoid(self.Dense_1(s))
        return x * s[:, None, None, :]


class InvertedResidual(nn.Module):
    def __init__(self, inp: int, exp: int, out: int, kernel: int,
                 stride: int, use_se: bool, use_hs: bool):
        super().__init__()
        self.stride, self.use_hs, self.use_se = stride, use_hs, use_se
        self.expand = exp != inp
        self.residual = stride == 1 and inp == out
        j = 0
        if self.expand:
            self.Conv_0 = ConvKernel(inp, exp, 1)
            self.GroupNorm_0 = GroupNorm(exp, min(8, exp))
            j = 1
        self.add_module(f"Conv_{j}", ConvKernel(exp, exp, kernel, groups=exp))
        self.add_module(f"GroupNorm_{j}", GroupNorm(exp, min(8, exp)))
        if use_se:
            self.SqueezeExcite_0 = SqueezeExcite(exp)
        self.add_module(f"Conv_{j + 1}", ConvKernel(exp, out, 1))
        self.add_module(f"GroupNorm_{j + 1}", GroupNorm(out, min(8, out)))
        self.j = j

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = hard_swish if self.use_hs else torch.relu
        y, j = x, self.j
        if self.expand:
            y = act(self.GroupNorm_0(self.Conv_0(y)))
        y = getattr(self, f"Conv_{j}")(y, self.stride)
        y = act(getattr(self, f"GroupNorm_{j}")(y))
        if self.use_se:
            y = self.SqueezeExcite_0(y)
        y = getattr(self, f"Conv_{j + 1}")(y)
        y = getattr(self, f"GroupNorm_{j + 1}")(y)
        return y + x if self.residual else y


# (kernel, exp, out, SE, HS, stride): the MobileNetV3-Small spec
_V3_SMALL: Sequence[Tuple[int, int, int, bool, bool, int]] = (
    (3, 16, 16, True, False, 2),
    (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1),
    (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1),
    (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1),
    (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2),
    (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
)


class MobileNetV3Small(FlaxInit):
    """A flat ``[n, side * side]`` input is a square 1-channel image."""

    def __init__(self, num_classes: int,
                 input_shape: Sequence[int] = (28, 28, 1)):
        super().__init__()
        _, _, c = _image_shape(input_shape)
        self.Conv_0 = ConvKernel(c, 16, 3)
        self.GroupNorm_0 = GroupNorm(16, 8)
        inp = 16
        for i, (k, e, o, se, hs, s) in enumerate(_V3_SMALL):
            self.add_module(f"InvertedResidual_{i}",
                            InvertedResidual(inp, e, o, k, s, se, hs))
            inp = o
        self.Conv_1 = ConvKernel(inp, 576, 1)
        self.GroupNorm_1 = GroupNorm(576, 8)
        self.Dense_0 = nn.Linear(576, 1024)
        self.Dense_1 = nn.Linear(1024, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = hard_swish(self.GroupNorm_0(self.Conv_0(_as_image(x), 2)))
        for i in range(len(_V3_SMALL)):
            x = getattr(self, f"InvertedResidual_{i}")(x)
        x = hard_swish(self.GroupNorm_1(self.Conv_1(x)))
        x = hard_swish(self.Dense_0(x.mean(dim=(1, 2))))
        return self.Dense_1(x)
