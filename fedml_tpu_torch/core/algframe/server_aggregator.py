"""User-pluggable server aggregator for the simulator path (counterpart of
``fedml_tpu/core/algframe/server_aggregator.py``).

Parity target: reference ``core/alg_frame/server_aggregator.py:14`` (ABC
with ``on_before_aggregation`` :44 / ``aggregate`` :75 /
``on_after_aggregation`` :90 hooks). The hooks operate on the round's
update **matrix** [K, D] (float32, the JAX package's flat layout, rows in
sampled-client order) plus the weights [K], both torch tensors on the
engine's device, and return the aggregate vector [D]. Passing an instance
to ``FedMLRunner`` puts the GPU engine on its host robust path.

When a defense is also enabled the defense takes precedence and the user
aggregator is skipped with a warning.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Tuple

import torch


class ServerAggregator(ABC):
    """Override ``aggregate``; the before/after hooks are optional."""

    def on_before_aggregation(
            self, update_matrix: torch.Tensor, weights: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return update_matrix, weights

    @abstractmethod
    def aggregate(self, update_matrix: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
        """[K, D] stacked client updates + [K] weights -> [D] aggregate."""

    def on_after_aggregation(self, agg_vec: torch.Tensor) -> torch.Tensor:
        return agg_vec
