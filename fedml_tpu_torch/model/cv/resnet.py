"""CIFAR ResNets (ResNet-20/56, 6n+2 layout) and ResNet-18, with GroupNorm
(counterpart of ``fedml_tpu/model/cv/resnet.py``).

Parameter names follow the flax modules' scope paths (``Conv_0.kernel``,
``BasicBlock_3.GroupNorm_1.scale``, ``Dense_0.weight``), so
:mod:`fedml_tpu_torch.interop` maps a flax parameter tree onto the
``state_dict`` by name. Conv kernels are stored HWIO, the fused kernel's
layout, so the fused path never transposes a weight; the Dense layer is a
``torch.nn.Linear`` (``[out, in]``).

``fused`` routes the narrow (<= 64 channel) BasicBlocks through the fused
conv->GN->residual->ReLU block (``core/kernels/conv_block``): ``"pallas"``
the CUDA kernel (its plain version for CPU tensors), ``"reference"`` the
same math in plain PyTorch, ``""`` (default) the unfused module path. All
three declare the same parameters.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...core.kernels.conv_block import (MAX_FUSED_CHANNELS, _conv_same,
                                        _group_norm, _same_pads, fused_block,
                                        reference_block)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal on [-2, 2] scaled to
    variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        t.mul_(std)
    return t


def init_dense_(m: nn.Linear, generator: torch.Generator) -> None:
    """flax ``nn.Dense``'s initialisers on a ``torch.nn.Linear``: a
    lecun_normal ``[in, out]`` kernel (stored transposed) and a zero
    bias."""
    w = torch.empty(m.in_features, m.out_features)
    lecun_normal_(w, m.in_features, generator)
    with torch.no_grad():
        m.weight.copy_(w.t())
        m.bias.zero_()


def max_pool(x: torch.Tensor, window: int, stride: int,
             same: bool = False) -> torch.Tensor:
    """flax ``nn.max_pool`` over NHWC: ``VALID`` (flax's default), or
    ``SAME`` padding, which pads each spatial side as XLA does (the odd
    element at the end) with -inf."""
    xn = x.permute(0, 3, 1, 2)
    if same:
        ph = _same_pads(int(x.shape[1]), window, stride)
        pw = _same_pads(int(x.shape[2]), window, stride)
        xn = F.pad(xn, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(xn, window, stride).permute(0, 2, 3, 1)


class ConvKernel(nn.Module):
    """A bias-free convolution's HWIO ``kernel`` (flax ``nn.Conv``);
    ``groups`` is its ``feature_group_count`` (kernel ``[k, k, cin /
    groups, cout]``)."""

    def __init__(self, cin: int, cout: int, ksize: int = 3, groups: int = 1):
        super().__init__()
        self.groups = groups
        self.kernel = nn.Parameter(torch.empty(ksize, ksize, cin // groups,
                                               cout))

    def reset_parameters(self, generator: torch.Generator) -> None:
        kh, kw, cin, _ = self.kernel.shape
        lecun_normal_(self.kernel, kh * kw * cin, generator)

    def forward(self, x: torch.Tensor, strides: int = 1) -> torch.Tensor:
        return _conv_same(x, self.kernel, strides, self.groups)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over NHWC: eps 1e-6 and the one-pass
    ``max(0, E[x^2] - E[x]^2)`` variance (torch's own has eps 1e-5)."""

    def __init__(self, features: int, groups: int):
        super().__init__()
        self.groups = groups
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _group_norm(x, self.scale, self.bias, self.groups, 1e-6)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, filters: int, strides: int = 1,
                 groups: int = 8, fused: str = ""):
        super().__init__()
        self.strides = strides
        self.fused = fused
        g = min(groups, filters)
        self.groups = g
        self.Conv_0 = ConvKernel(cin, filters)
        self.GroupNorm_0 = GroupNorm(filters, g)
        self.Conv_1 = ConvKernel(filters, filters)
        self.GroupNorm_1 = GroupNorm(filters, g)
        self.has_proj = strides != 1 or cin != filters
        if self.has_proj:
            self.Conv_2 = ConvKernel(cin, filters, ksize=1)
            self.GroupNorm_2 = GroupNorm(filters, g)
        # narrow stages only: the fused kernel holds one sample's
        # activations in one SM's shared memory
        self.use_fused = bool(fused) and filters <= MAX_FUSED_CHANNELS

    def block_params(self):
        p = {"w1": self.Conv_0.kernel, "g1_scale": self.GroupNorm_0.scale,
             "g1_bias": self.GroupNorm_0.bias, "w2": self.Conv_1.kernel,
             "g2_scale": self.GroupNorm_1.scale,
             "g2_bias": self.GroupNorm_1.bias}
        if self.has_proj:
            p.update(wp=self.Conv_2.kernel, gp_scale=self.GroupNorm_2.scale,
                     gp_bias=self.GroupNorm_2.bias)
        return p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_fused:
            impl = fused_block if self.fused == "pallas" else reference_block
            return impl(x, self.block_params(), strides=self.strides,
                        groups=self.groups)
        y = self.Conv_0(x, self.strides)
        y = torch.relu(self.GroupNorm_0(y))
        y = self.GroupNorm_1(self.Conv_1(y))
        residual = x
        if self.has_proj:
            residual = self.GroupNorm_2(self.Conv_2(x, self.strides))
        return torch.relu(residual + y)


class CifarResNet(nn.Module):
    """6n+2 ResNet: stages of n blocks at widths 16/32/64."""

    def __init__(self, num_classes: int, blocks_per_stage: int,
                 fused: str = "", in_channels: int = 3):
        super().__init__()
        self.fused = fused
        self.Conv_0 = ConvKernel(in_channels, 16)
        self.GroupNorm_0 = GroupNorm(16, 8)
        cin, k = 16, 0
        for stage, filters in enumerate((16, 32, 64)):
            for block in range(blocks_per_stage):
                strides = 2 if (stage > 0 and block == 0) else 1
                self.add_module(f"BasicBlock_{k}", BasicBlock(
                    cin, filters, strides, fused=fused))
                cin, k = filters, k + 1
        self.num_blocks = k
        self.Dense_0 = nn.Linear(64, num_classes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Initialise every parameter from ``generator`` with flax's
        initialisers (lecun_normal kernels, GN ones/zeros, zero Dense
        bias). The values differ from flax's: the parity tests copy flax's
        own through :mod:`fedml_tpu_torch.interop`."""
        for m in self.modules():
            if isinstance(m, (ConvKernel, GroupNorm)):
                m.reset_parameters(generator)
        init_dense_(self.Dense_0, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        for k in range(self.num_blocks):
            x = getattr(self, f"BasicBlock_{k}")(x)
        return self.Dense_0(x.mean(dim=(1, 2)))


class ResNet18(CifarResNet):
    """ImageNet-style ResNet-18 (``fedml_tpu/model/cv/resnet.py``
    ``ResNet18``): a stem, then 4 stages of 2 BasicBlocks at widths
    64/128/256/512 (the first block of stages 1-3 strided). Images of at
    most 64 rows get the CIFAR stem (3x3 conv); larger ones the 7x7
    stride-2 conv and a 3x3 stride-2 ``SAME`` max-pool. flax picks the stem
    from the input at each call; the port's parameter shapes depend on it,
    so it is fixed from ``input_shape`` (``(h, w, c)``) when built. With
    ``fused`` the two 64-channel blocks of stage 0 run the fused block;
    the wider stages stay on cuDNN."""

    def __init__(self, num_classes: int, input_shape=(32, 32, 3),
                 fused: str = ""):
        nn.Module.__init__(self)
        self.fused = fused
        self.small = int(input_shape[0]) <= 64
        cin = int(input_shape[-1])
        self.Conv_0 = ConvKernel(cin, 64, ksize=3 if self.small else 7)
        self.GroupNorm_0 = GroupNorm(64, 8)
        cin, k = 64, 0
        for stage, filters in enumerate((64, 128, 256, 512)):
            for block in range(2):
                strides = 2 if (stage > 0 and block == 0) else 1
                self.add_module(f"BasicBlock_{k}", BasicBlock(
                    cin, filters, strides, fused=fused))
                cin, k = filters, k + 1
        self.num_blocks = k
        self.Dense_0 = nn.Linear(512, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x, 1 if self.small else 2)
        x = torch.relu(self.GroupNorm_0(x))
        if not self.small:
            x = max_pool(x, 3, 2, same=True)
        for k in range(self.num_blocks):
            x = getattr(self, f"BasicBlock_{k}")(x)
        return self.Dense_0(x.mean(dim=(1, 2)))


def create_resnet(name: str, num_classes: int, fused: str = "",
                  input_shape=(32, 32, 3)) -> nn.Module:
    name = name.lower()
    if name in ("resnet20", "resnet20_gn"):
        return CifarResNet(num_classes, blocks_per_stage=3, fused=fused)
    if name in ("resnet56", "resnet56_gn", "resnet"):
        return CifarResNet(num_classes, blocks_per_stage=9, fused=fused)
    if name in ("resnet18", "resnet18_gn"):
        return ResNet18(num_classes, input_shape, fused=fused)
    raise ValueError(f"unknown resnet variant {name!r}")
