"""Linear / MLP models (counterpart of ``fedml_tpu/model/linear.py``).

Layers are named as flax names its ``nn.Dense`` scopes (``Dense_0``,
``Dense_1``, ...), so :mod:`fedml_tpu_torch.interop` carries a flax
parameter tree across unchanged (the one layout change, ``[in, out]`` ->
``[out, in]``, is the interop's). The MLP has no dropout: the JAX
package's default rate is 0.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .cv.resnet import lecun_normal_


class MLP(nn.Module):
    """Flat input -> ``Dense_k`` layers with ReLU between them."""

    def __init__(self, in_features: int, num_classes: int,
                 hidden: Sequence[int] = (128, 64)):
        super().__init__()
        widths = (in_features, *hidden, num_classes)
        self.depth = len(widths) - 1
        for k in range(self.depth):
            self.add_module(f"Dense_{k}", nn.Linear(widths[k], widths[k + 1]))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers: lecun_normal kernels, zero biases."""
        for m in self.children():
            w = torch.empty(m.in_features, m.out_features)
            lecun_normal_(w, m.in_features, generator)
            with torch.no_grad():
                m.weight.copy_(w.t())
                m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for k in range(self.depth):
            x = getattr(self, f"Dense_{k}")(x)
            if k < self.depth - 1:
                x = torch.relu(x)
        return x


class LogisticRegression(MLP):
    """One Dense layer: an MLP with no hidden layer."""

    def __init__(self, in_features: int, num_classes: int):
        super().__init__(in_features, num_classes, hidden=())
