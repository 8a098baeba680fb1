"""MNIST GAN generator / discriminator (counterpart of
``fedml_tpu/model/cv/gan.py``, used by FedGAN): flax-named ``Dense_k``
layers."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .cnn import FlaxInit


class Generator(FlaxInit):
    """z -> Dense 256 / 512 / 1024 (relu) -> Dense ``img_dim`` -> tanh."""

    def __init__(self, latent_dim: int = 100, img_dim: int = 784):
        super().__init__()
        widths = (latent_dim, 256, 512, 1024, img_dim)
        for k in range(4):
            self.add_module(f"Dense_{k}", nn.Linear(widths[k], widths[k + 1]))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = z
        for k in range(3):
            h = torch.relu(getattr(self, f"Dense_{k}")(h))
        return torch.tanh(self.Dense_3(h))


class Discriminator(FlaxInit):
    """Flatten -> Dense 512 / 256 (leaky relu 0.2) -> Dense 1 (a logit)."""

    def __init__(self, img_dim: int = 784):
        super().__init__()
        self.Dense_0 = nn.Linear(img_dim, 512)
        self.Dense_1 = nn.Linear(512, 256)
        self.Dense_2 = nn.Linear(256, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.Dense_0(x.reshape(x.shape[0], -1)), 0.2)
        h = F.leaky_relu(self.Dense_1(h), 0.2)
        return self.Dense_2(h)
