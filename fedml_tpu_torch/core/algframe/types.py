"""Datatypes of the algorithm frame (counterpart of
``fedml_tpu/core/algframe/types.py``).

The JAX package makes these pytrees so a whole round can flow through
``jit``; PyTorch runs eagerly, so here they are plain dataclasses. Model
parameters are ``Params``: an ordered dict from the module's state-dict
names to tensors, which is what lets local training, the FedAvg sum and the
server step stay plain functions on tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class ClientData:
    """One client's local dataset, padded to a static shape.

    ``x``: [n_batches, batch_size, ...features]
    ``y``: [n_batches, batch_size] int labels
    ``mask``: [n_batches, batch_size] — 1.0 for real samples, 0.0 for padding
    ``num_samples``: the aggregation weight ``n_k`` (float32)

    The loader fills the fields with numpy arrays stacked over clients;
    :meth:`to` moves them to a device as tensors.
    """
    x: Any
    y: Any
    mask: Any
    num_samples: Any

    def to(self, device: torch.device) -> "ClientData":
        def conv(a):
            if not torch.is_tensor(a):
                a = torch.as_tensor(np.asarray(a))
            return a.to(device)
        return ClientData(conv(self.x), conv(self.y), conv(self.mask),
                          conv(self.num_samples))

    def client(self, i: int) -> "ClientData":
        """Client ``i``'s slice of data stacked over clients."""
        return ClientData(self.x[i], self.y[i], self.mask[i],
                          self.num_samples[i])


@dataclasses.dataclass
class ClientOutput:
    """What one simulated client returns from local training: the delta
    ``local - global``, its aggregation weight and summed metrics."""
    update: Params
    weight: torch.Tensor
    metrics: Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainHyper:
    """Per-round hyperparameters threaded into local training.
    ``work_scale`` is the fraction of a client's local steps it runs
    (1.0 = all of them)."""
    learning_rate: float
    epochs: int = 1
    work_scale: float = 1.0
