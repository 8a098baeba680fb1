"""VGG-11/16 with GroupNorm (counterpart of ``fedml_tpu/model/cv/vgg.py``):
per entry of the config a bias-free conv 3x3 ``SAME`` -> GroupNorm(8) ->
relu, or a 2/2 max-pool (``"M"``); then the NHWC flatten, Dense 512 ->
relu -> dropout 0.5 (flax's ``Dropout_0`` masks, :mod:`..dropout`) ->
Dense ``num_classes``."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..dropout import Dropout
from .cnn import FlaxInit, _image_shape
from .resnet import ConvKernel, GroupNorm, max_pool

_CFG = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"),
}


class VGG(FlaxInit):
    has_dropout = True

    def __init__(self, num_classes: int, cfg: Sequence[Union[int, str]],
                 dropout: float = 0.5,
                 input_shape: Sequence[int] = (32, 32, 3)):
        super().__init__()
        h, w, cin = _image_shape(input_shape)
        self.cfg = tuple(cfg)
        k = 0
        for v in self.cfg:
            if v == "M":
                h, w = h // 2, w // 2
                continue
            self.add_module(f"Conv_{k}", ConvKernel(cin, int(v)))
            self.add_module(f"GroupNorm_{k}", GroupNorm(int(v), 8))
            cin, k = int(v), k + 1
        self.Dense_0 = nn.Linear(h * w * cin, 512)
        self.Dropout_0 = Dropout(dropout, "Dropout_0")
        self.Dense_1 = nn.Linear(512, num_classes)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Tensor] = None) -> torch.Tensor:
        k = 0
        for v in self.cfg:
            if v == "M":
                x = max_pool(x, 2, 2)
                continue
            x = getattr(self, f"Conv_{k}")(x)
            x = torch.relu(getattr(self, f"GroupNorm_{k}")(x))
            k += 1
        x = torch.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        return self.Dense_1(self.Dropout_0(x, rng))


def create_vgg(name: str, num_classes: int,
               input_shape: Sequence[int] = (32, 32, 3)) -> VGG:
    cfg = _CFG.get(name.lower())
    if cfg is None:
        raise ValueError(f"unknown VGG {name!r} (known: {sorted(_CFG)})")
    return VGG(num_classes, cfg, input_shape=input_shape)
