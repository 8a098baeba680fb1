"""EfficientNet-lite, MBConv backbone with GroupNorm (counterpart of
``fedml_tpu/model/cv/efficientnet.py``): ReLU6, squeeze-excite as two
1x1 convs with biases, width ``max(8, int(f * wm + 4) // 8 * 8)`` and
depth ``max(1, round(n * dm))`` per stage, dropout 0.2 (flax's
``Dropout_0`` masks) before the head. Depthwise convs are grouped convs
(see :mod:`.mobilenet`); names follow flax's auto-naming
(``MBConv_k.{Conv_j, GroupNorm_j, SqueezeExcite_0.Conv_j}``)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..dropout import Dropout
from .cnn import Conv, FlaxInit, _image_shape
from .resnet import ConvKernel, GroupNorm


class SqueezeExcite(nn.Module):
    def __init__(self, filters: int, se_ratio: float = 0.25):
        super().__init__()
        r = max(1, int(filters * se_ratio))
        self.Conv_0 = Conv(filters, r, 1)
        self.Conv_1 = Conv(r, filters, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(1, 2), keepdim=True)
        s = torch.sigmoid(self.Conv_1(torch.relu(self.Conv_0(s))))
        return x * s


class MBConv(nn.Module):
    def __init__(self, filters_in: int, filters_out: int, expand: int,
                 kernel: int = 3, strides: int = 1, use_se: bool = True):
        super().__init__()
        self.strides, self.use_se = strides, use_se
        self.expanded = expand != 1
        self.residual = strides == 1 and filters_in == filters_out
        c, j = filters_in, 0
        if self.expanded:
            c = filters_in * expand
            self.Conv_0 = ConvKernel(filters_in, c, 1)
            self.GroupNorm_0 = GroupNorm(c, 8)
            j = 1
        self.add_module(f"Conv_{j}", ConvKernel(c, c, kernel, groups=c))
        self.add_module(f"GroupNorm_{j}", GroupNorm(c, 8))
        if use_se:
            self.SqueezeExcite_0 = SqueezeExcite(c)
        self.add_module(f"Conv_{j + 1}", ConvKernel(c, filters_out, 1))
        self.add_module(f"GroupNorm_{j + 1}",
                        GroupNorm(filters_out, min(8, filters_out)))
        self.j = j

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, j = x, self.j
        if self.expanded:
            h = F.relu6(self.GroupNorm_0(self.Conv_0(h)))
        h = getattr(self, f"Conv_{j}")(h, self.strides)
        h = F.relu6(getattr(self, f"GroupNorm_{j}")(h))
        if self.use_se:
            h = self.SqueezeExcite_0(h)
        h = getattr(self, f"Conv_{j + 1}")(h)
        h = getattr(self, f"GroupNorm_{j + 1}")(h)
        return h + x if self.residual else h


# (expand, filters, blocks, strides, kernel) per stage: the B0 layout
_B0_STAGES: Sequence[Tuple[int, int, int, int, int]] = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


class EfficientNetLite(FlaxInit):
    has_dropout = True

    def __init__(self, num_classes: int, width_mult: float = 1.0,
                 depth_mult: float = 1.0, dropout: float = 0.2,
                 input_shape: Sequence[int] = (32, 32, 3)):
        super().__init__()
        _, _, cin = _image_shape(input_shape)

        def w(f):
            return max(8, int(f * width_mult + 4) // 8 * 8)

        def d(n):
            return max(1, round(n * depth_mult))

        self.Conv_0 = ConvKernel(cin, w(32), 3)
        self.GroupNorm_0 = GroupNorm(w(32), 8)
        c, k = w(32), 0
        for expand, filters, blocks, strides, kernel in _B0_STAGES:
            for b in range(d(blocks)):
                s = strides if b == 0 else 1
                self.add_module(f"MBConv_{k}", MBConv(c, w(filters), expand,
                                                      kernel, s))
                c, k = w(filters), k + 1
        self.num_blocks = k
        self.Conv_1 = ConvKernel(c, w(1280), 1)
        self.GroupNorm_1 = GroupNorm(w(1280), 8)
        self.Dropout_0 = Dropout(dropout, "Dropout_0")
        self.Dense_0 = nn.Linear(w(1280), num_classes)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = F.relu6(self.GroupNorm_0(self.Conv_0(x, 2)))
        for k in range(self.num_blocks):
            x = getattr(self, f"MBConv_{k}")(x)
        x = F.relu6(self.GroupNorm_1(self.Conv_1(x)))
        x = self.Dropout_0(x.mean(dim=(1, 2)), rng)
        return self.Dense_0(x)


def create_efficientnet(name: str, num_classes: int,
                        input_shape: Sequence[int] = (32, 32, 3)
                        ) -> EfficientNetLite:
    name = name.lower()
    scale = {"efficientnet": (1.0, 1.0), "efficientnet-b0": (1.0, 1.0),
             "efficientnet-b1": (1.0, 1.1), "efficientnet-b2": (1.1, 1.2)}
    wm, dm = scale.get(name, (1.0, 1.0))
    return EfficientNetLite(num_classes, width_mult=wm, depth_mult=dm,
                            input_shape=input_shape)
