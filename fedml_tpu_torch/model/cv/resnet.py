"""CIFAR ResNets (ResNet-20/56, 6n+2 layout) with GroupNorm (counterpart of
``fedml_tpu/model/cv/resnet.py``).

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
from torch import nn

from ...core.kernels.conv_block import (MAX_FUSED_CHANNELS, _conv_same,
                                        _group_norm, fused_block,
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


class ConvKernel(nn.Module):
    """A bias-free convolution's HWIO ``kernel`` (flax ``nn.Conv``)."""

    def __init__(self, cin: int, cout: int, ksize: int = 3):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(ksize, ksize, cin, cout))

    def reset_parameters(self, generator: torch.Generator) -> None:
        kh, kw, cin, _ = self.kernel.shape
        lecun_normal_(self.kernel, kh * kw * cin, generator)

    def forward(self, x: torch.Tensor, strides: int = 1) -> torch.Tensor:
        return _conv_same(x, self.kernel, strides)


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
        with torch.no_grad():
            w = torch.empty(self.Dense_0.in_features,
                            self.Dense_0.out_features)
            lecun_normal_(w, self.Dense_0.in_features, generator)
            self.Dense_0.weight.copy_(w.t())
            self.Dense_0.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        for k in range(self.num_blocks):
            x = getattr(self, f"BasicBlock_{k}")(x)
        return self.Dense_0(x.mean(dim=(1, 2)))


def create_resnet(name: str, num_classes: int, fused: str = "") -> nn.Module:
    name = name.lower()
    if name in ("resnet20", "resnet20_gn"):
        return CifarResNet(num_classes, blocks_per_stage=3, fused=fused)
    if name in ("resnet56", "resnet56_gn", "resnet"):
        return CifarResNet(num_classes, blocks_per_stage=9, fused=fused)
    if name in ("resnet18", "resnet18_gn"):
        raise NotImplementedError(
            "model='resnet18' is not ported to fedml_tpu_torch yet "
            "(ported: resnet20, resnet56)")
    raise ValueError(f"unknown resnet variant {name!r}")
