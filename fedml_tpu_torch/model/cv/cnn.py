"""CNNs for federated vision tasks (counterpart of
``fedml_tpu/model/cv/cnn.py``): ``CNNFemnist`` (the FedAvg paper's CNN,
with dropout), ``SimpleCNN`` (CIFAR, GroupNorm) and ``DeviceCNN`` (the
on-device LeNet-class CNN).

As flax's ``nn.Conv`` defaults: ``SAME`` padding and a bias, kernels HWIO
(``Conv_k.kernel``, ``Conv_k.bias``), activations NHWC. The flatten before
``Dense_0`` is NHWC's, flax's order (and the native trainer's for
``DeviceCNN``); ``Dense_k`` is a ``torch.nn.Linear`` (the interop
transposes the kernel).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...core.kernels.conv_block import _conv_same
from ..dropout import Dropout
from .resnet import (ConvKernel, GroupNorm, init_dense_, lecun_normal_,
                     max_pool)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides=(s, s))``: ``SAME``, with
    a bias."""

    def __init__(self, cin: int, cout: int, ksize: int, strides: int = 1):
        super().__init__()
        self.strides = strides
        self.kernel = nn.Parameter(torch.empty(ksize, ksize, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, generator: torch.Generator) -> None:
        kh, kw, cin, _ = self.kernel.shape
        lecun_normal_(self.kernel, kh * kw * cin, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv_same(x, self.kernel, self.strides)
        return y + self.bias.to(y.dtype)


def _as_image(x: torch.Tensor) -> torch.Tensor:
    """A flat input ``[n, side * side]`` as a square 1-channel NHWC
    image."""
    if x.dim() == 2:
        side = int(round(x.shape[-1] ** 0.5))
        x = x.reshape(x.shape[0], side, side, 1)
    return x


class FlaxInit(nn.Module):
    """A model whose layers take flax's initialisers (lecun_normal
    kernels, zero biases, GN ones and zeros), drawn from ``generator`` in
    module order; the values differ from flax's."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, (Conv, ConvKernel, GroupNorm)):
                m.reset_parameters(generator)
            elif isinstance(m, nn.Linear):
                init_dense_(m, generator)


class CNNFemnist(FlaxInit):
    """conv3x3(32) relu, conv3x3(64) relu, maxpool 2, dropout ``dropout``,
    Dense 128 relu, dropout 0.5, Dense ``num_classes``."""
    has_dropout = True

    def __init__(self, num_classes: int = 62, dropout: float = 0.25,
                 input_shape: Sequence[int] = (28, 28, 1)):
        super().__init__()
        h, w, c = _image_shape(input_shape)
        self.Conv_0 = Conv(c, 32, 3)
        self.Conv_1 = Conv(32, 64, 3)
        self.Dropout_0 = Dropout(dropout, "Dropout_0")
        self.Dense_0 = nn.Linear((h // 2) * (w // 2) * 64, 128)
        self.Dropout_1 = Dropout(0.5, "Dropout_1")
        self.Dense_1 = nn.Linear(128, num_classes)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = _as_image(x)
        x = torch.relu(self.Conv_0(x))
        x = torch.relu(self.Conv_1(x))
        x = self.Dropout_0(max_pool(x, 2, 2), rng)
        x = torch.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        x = self.Dropout_1(x, rng)
        return self.Dense_1(x)


class SimpleCNN(FlaxInit):
    """(conv5x5 -> GroupNorm(8) -> relu -> maxpool 2) at 32 and 64
    channels, then Dense 384, 192 (relu) and ``num_classes``.

    On a 1-channel input the stem is an im2col GEMM
    (``lenet.GemmConv``): on the H100, cuDNN's filter gradient of this
    5x5 1-to-32 stem at batch 8 of 28x28 is 0.340 off a float64 reference
    whose largest entry is 291.7, under every cuDNN setting, where the
    GEMM's is 9.8e-5 (``scripts/tail_probe.py wgrad``)."""

    def __init__(self, num_classes: int = 10,
                 input_shape: Sequence[int] = (32, 32, 3)):
        super().__init__()
        from .lenet import GemmConv
        h, w, c = _image_shape(input_shape)
        self.Conv_0 = (GemmConv if c == 1 else Conv)(c, 32, 5)
        self.GroupNorm_0 = GroupNorm(32, 8)
        self.Conv_1 = Conv(32, 64, 5)
        self.GroupNorm_1 = GroupNorm(64, 8)
        self.Dense_0 = nn.Linear((h // 4) * (w // 4) * 64, 384)
        self.Dense_1 = nn.Linear(384, 192)
        self.Dense_2 = nn.Linear(192, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(torch.relu(self.GroupNorm_0(self.Conv_0(x))), 2, 2)
        x = max_pool(torch.relu(self.GroupNorm_1(self.Conv_1(x))), 2, 2)
        x = torch.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        x = torch.relu(self.Dense_1(x))
        return self.Dense_2(x)


class DeviceCNN(FlaxInit):
    """(conv3x3 SAME -> relu -> maxpool 2) at ``features[0]`` and
    ``features[1]`` channels, then Dense ``num_classes``."""

    def __init__(self, num_classes: int = 10, features=(8, 16),
                 input_shape: Sequence[int] = (28, 28, 1)):
        super().__init__()
        h, w, c = _image_shape(input_shape)
        self.Conv_0 = Conv(c, features[0], 3)
        self.Conv_1 = Conv(features[0], features[1], 3)
        self.Dense_0 = nn.Linear((h // 4) * (w // 4) * features[1],
                                 num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _as_image(x)
        x = max_pool(torch.relu(self.Conv_0(x)), 2, 2)
        x = max_pool(torch.relu(self.Conv_1(x)), 2, 2)
        return self.Dense_0(x.reshape(x.shape[0], -1))


def _image_shape(input_shape: Sequence[int]):
    """``(h, w, c)`` of one sample; a flat ``(side * side,)`` sample is a
    square 1-channel image."""
    if len(input_shape) == 1:
        side = int(round(int(input_shape[0]) ** 0.5))
        return side, side, 1
    h, w, c = (int(d) for d in input_shape)
    return h, w, c
