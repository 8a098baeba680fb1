"""Base topology interface (reference ``base_topology_manager.py:4``)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List

import numpy as np


class BaseTopologyManager(ABC):
    n: int
    topology: np.ndarray  # [n, n] row-stochastic mixing weights

    @abstractmethod
    def generate_topology(self) -> None:
        ...

    def get_in_neighbor_idx_list(self, node_index: int) -> List[int]:
        """Nodes whose values flow INTO ``node_index`` (nonzero column)."""
        col = self.topology[:, node_index]
        return [i for i in range(self.n)
                if col[i] > 0 and i != node_index]

    def get_out_neighbor_idx_list(self, node_index: int) -> List[int]:
        row = self.topology[node_index]
        return [i for i in range(self.n)
                if row[i] > 0 and i != node_index]

    def get_in_neighbor_weights(self, node_index: int) -> List[float]:
        return list(self.topology[:, node_index])

    def get_out_neighbor_weights(self, node_index: int) -> List[float]:
        return list(self.topology[node_index])

    def mixing_matrix(self) -> np.ndarray:
        return self.topology

    def to_ppermute_pairs(self) -> List[tuple]:
        """(src, dst) pairs for ``jax.lax.ppermute`` — one pair per directed
        edge (excluding self-loops)."""
        pairs = []
        for i in range(self.n):
            for j in self.get_out_neighbor_idx_list(i):
                pairs.append((i, j))
        return pairs
